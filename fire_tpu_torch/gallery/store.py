"""SQLite persistence (counterpart of ``fire_tpu.gallery.store``).

Same single-table schema (``faces(id INTEGER PRIMARY KEY AUTOINCREMENT,
label TEXT NOT NULL, embedding BLOB NOT NULL)``, embeddings as raw f32
bytes), so a database written by either package opens in the other.
Encrypted databases wait for the port of ``gallery/crypto.py``
(the recognizer refuses a password).
"""

from __future__ import annotations

import logging
import os
import sqlite3
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

class FaceStore:
    def __init__(self, sqlite_db_path: str, embedding_dim: int = 128):
        self.sqlite_db_path = sqlite_db_path
        self.embedding_dim = embedding_dim
        self.conn: Optional[sqlite3.Connection] = None
        self._open()

    def _open(self) -> None:
        d = os.path.dirname(self.sqlite_db_path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.conn = sqlite3.connect(self.sqlite_db_path)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA synchronous=NORMAL")
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS faces ("
            " id INTEGER PRIMARY KEY AUTOINCREMENT,"
            " label TEXT NOT NULL,"
            " embedding BLOB NOT NULL)"
        )
        self.conn.commit()

    def save(self) -> None:
        """Flush to disk and close."""
        if self.conn is None:
            return
        self.conn.commit()
        self.conn.close()
        self.conn = None

    def add(self, label: str, embedding: np.ndarray) -> int:
        """Insert; returns the new row id or −1 on failure."""
        try:
            cur = self.conn.execute(
                "INSERT INTO faces (label, embedding) VALUES (?, ?)",
                (label, np.asarray(embedding, np.float32).tobytes()),
            )
            self.conn.commit()
            return int(cur.lastrowid)
        except Exception as e:
            log.error("Error adding face to SQLite: %s", e)
            return -1

    def load_all(self) -> List[Tuple[int, str, bytes]]:
        try:
            return list(self.conn.execute("SELECT id, label, embedding FROM faces"))
        except Exception as e:
            log.error("Error loading embeddings from SQLite: %s", e)
            return []

    def get_embedding(self, db_id: int) -> Optional[np.ndarray]:
        """Re-read + renormalise one embedding."""
        row = self.conn.execute("SELECT embedding FROM faces WHERE id=?", (db_id,)).fetchone()
        if row is None:
            return None
        emb = np.frombuffer(row[0], np.float32).copy()
        n = np.linalg.norm(emb)
        if n > 0:
            emb /= n
        return emb

    def update_label(self, db_id: int, new_label: str) -> None:
        self.conn.execute("UPDATE faces SET label = ? WHERE id = ?", (new_label, db_id))
        self.conn.commit()

    def update_labels(self, db_ids: List[int], new_label: str) -> None:
        self.conn.executemany("UPDATE faces SET label = ? WHERE id = ?",
                              [(new_label, i) for i in db_ids])
        self.conn.commit()

    def count(self) -> int:
        return int(self.conn.execute("SELECT COUNT(*) FROM faces").fetchone()[0])

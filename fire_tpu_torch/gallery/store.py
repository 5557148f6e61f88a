"""SQLite persistence (counterpart of ``fire_tpu.gallery.store``).

Same single-table schema (``faces(id INTEGER PRIMARY KEY AUTOINCREMENT,
label TEXT NOT NULL, embedding BLOB NOT NULL)``, embeddings as raw f32
bytes), so a database written by either package opens in the other.

Encrypted mode, as in JAX: the database lives in memory, hydrated at
open from the decrypted file (decrypt → temp file → ``sqlite3`` backup)
and persisted at ``save`` by the reverse (backup → temp file → whole-file
encryption, :mod:`fire_tpu_torch.gallery.crypto`).  A file that does not
decrypt (a wrong password) leaves an empty database and is logged, not
raised.
"""

from __future__ import annotations

import logging
import os
import sqlite3
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from fire_tpu_torch.gallery.crypto import Encryptor

log = logging.getLogger(__name__)


class FaceStore:
    def __init__(self, sqlite_db_path: Optional[str],
                 sqlite_db_encrypted_path: Optional[str] = None,
                 encryptor: Optional[Encryptor] = None, embedding_dim: int = 128):
        self.sqlite_db_path = sqlite_db_path
        self.sqlite_db_encrypted_path = sqlite_db_encrypted_path
        self.encryptor = encryptor
        self.embedding_dim = embedding_dim
        self.conn: Optional[sqlite3.Connection] = None
        self._open()

    @property
    def encrypted(self) -> bool:
        return bool(self.encryptor and self.sqlite_db_encrypted_path)

    def _open(self) -> None:
        if self.encrypted:
            self.conn = sqlite3.connect(":memory:")
            if os.path.exists(self.sqlite_db_encrypted_path):
                try:
                    self._hydrate(self.encryptor.read_and_decrypt(self.sqlite_db_encrypted_path))
                    log.info("Decrypted and loaded existing database into memory.")
                except Exception as e:  # keep running with an empty database, as JAX does
                    log.error("Failed to load encrypted database: %s", e)
        else:
            if self.sqlite_db_path is None:
                raise ValueError("FaceStore needs sqlite_db_path, or an encrypted path "
                                 "and an encryptor")
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

    def _hydrate(self, blob: bytes) -> None:
        fd, tmp = tempfile.mkstemp(suffix=".db")
        os.close(fd)
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            disk = sqlite3.connect(tmp)
            try:
                disk.backup(self.conn)
            finally:
                disk.close()
        finally:
            os.remove(tmp)

    def _dump(self) -> bytes:
        fd, tmp = tempfile.mkstemp(suffix=".db")
        os.close(fd)
        try:
            disk = sqlite3.connect(tmp)
            try:
                self.conn.backup(disk)
            finally:
                disk.close()
            with open(tmp, "rb") as f:
                return f.read()
        finally:
            os.remove(tmp)

    def save(self) -> None:
        """Flush to disk (encrypted: the whole database, re-encrypted) and
        close."""
        if self.conn is None:
            return
        if self.encrypted:
            blob = self._dump()
            d = os.path.dirname(self.sqlite_db_encrypted_path)
            if d:
                os.makedirs(d, exist_ok=True)
            self.encryptor.encrypt_and_write(self.sqlite_db_encrypted_path, blob)
        else:
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

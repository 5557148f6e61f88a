"""Device-resident exact cosine top-k gallery (counterpart of
``fire_tpu.gallery.index.DeviceGallery``).

A row-normalised (padded capacity, D) float32 master plus its bf16
shadow live on the device; hot-path matching reads the shadow (half the
bytes).  A k=1 query goes through kernel K1
(:func:`fire_tpu_torch.ops.cosine_top1.cosine_top1`), anything else
through the plain top-k.  Semantics follow HNSWManager as in JAX: ids
are insertion counters, ``query`` returns (ids, cosine distances), group
relabel refuses to unify conflicting known labels, and a corrupt
persisted index falls back to a fresh one rebuilt from SQLite.
:class:`ShardedGalleryView` answers the same queries from row shards
spread over a mesh.

Persistence is the JAX package's, byte for byte: the snapshot triplet
(index ``.npy`` bytes, labels pickle, db_ids pickle) plus the
``<index>.journal`` of length-prefixed pickled records, so either
package reads the other's files.  With an ``encryptor`` each file of the
triplet is one encrypted blob, and each journal record's payload is
encrypted on its own (:mod:`fire_tpu_torch.gallery.crypto`, the JAX
package's format).
"""

from __future__ import annotations

import io
import logging
import os
import pickle
from typing import List, Optional

import numpy as np
import torch

from fire_tpu_torch.device import DeviceLike, resolve_device
from fire_tpu_torch.gallery.crypto import Encryptor
from fire_tpu_torch.ops.cosine_top1 import cosine_top1
from fire_tpu_torch.ops.gallery_match import cosine_topk, cosine_topk_f32
from fire_tpu_torch.runtime.graphs import HostStaging

log = logging.getLogger(__name__)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class DeviceGallery:
    """Exact cosine top-k index with HNSWManager-compatible semantics."""

    QUERY_ROWS = 1024  # queries per plain top-k product

    def __init__(
        self,
        embedding_dim: int,
        index_path: Optional[str] = None,
        labels_path: Optional[str] = None,
        db_ids_path: Optional[str] = None,
        encryptor: Optional[Encryptor] = None,
        capacity: int = 100_000,
        journal_compact_threshold: int = 4096,
        strict_f32_match: bool = False,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self._staging = HostStaging()  # the K1 queries' pinned upload buffers
        self.embedding_dim = embedding_dim
        self.capacity = capacity
        # 2048-row padding for large galleries (100,000 → 100,352 =
        # 49 × 2048), 128 for small test galleries
        self.padded = _round_up(capacity, 2048 if capacity >= 2048 else 128)
        self.index_path = index_path
        self.labels_path = labels_path
        self.db_ids_path = db_ids_path
        self.encryptor = encryptor
        self.journal_compact_threshold = journal_compact_threshold
        self.strict_f32_match = strict_f32_match

        self.labels: List[str] = []
        self.db_ids: List[int] = []
        self._reset_matrix()
        self._snapshot_rows = 0
        self._journal_rows = 0
        self._labels_dirty = False
        self._force_compact = False
        # ``add`` buffers rows host-side; one device write flushes them
        # before the next query (_flush_pending)
        self._pending: List[np.ndarray] = []
        # host copies of rows added since the last compaction (journal
        # appends read these instead of a device readback)
        self._fresh_host: List[np.ndarray] = []
        self._fresh_start = 0

        paths = [index_path, labels_path, db_ids_path]
        if all(p and os.path.exists(p) for p in paths):
            self._load()
        else:
            log.info("Initialized new device gallery (capacity %d).", capacity)

    def _reset_matrix(self, host: Optional[np.ndarray] = None) -> None:
        """A new matrix (zeros, or ``host`` with one row per label) and a
        new device count.  Captured step graphs read the old ones, so the
        matrix version moves on and their owners capture anew."""
        if host is None:
            self._gal = torch.zeros((self.padded, self.embedding_dim), dtype=torch.float32,
                                    device=self.device)
        else:
            self._gal = torch.from_numpy(host).to(self.device)
        self._gal16 = self._gal.to(torch.bfloat16)
        self._count_dev = torch.full((), len(self.labels), dtype=torch.int32, device=self.device)
        self.matrix_version = getattr(self, "matrix_version", -1) + 1

    # -- size --------------------------------------------------------------

    @property
    def count(self) -> int:
        return len(self.labels)

    def get_current_count(self) -> int:  # hnswlib API parity
        return self.count

    @property
    def gal_matmul(self) -> torch.Tensor:
        """The matching operand of the batched step: the bf16 shadow, or
        the f32 master under ``strict_f32_match``."""
        self._flush_pending()
        return self._gal if self.strict_f32_match else self._gal16

    @property
    def count_dev(self) -> torch.Tensor:
        """The rows on the device, as a 0-d int32 tensor there: the
        count a captured step reads (JAX passes ``count`` into the jitted
        step as an operand).  It is written in stream order wherever rows
        land, so a step queued before an enrolment sees the count it was
        queued with, and nothing waits for the card."""
        self._flush_pending()
        return self._count_dev

    def _set_rows(self, start: int, block: np.ndarray) -> None:
        """Write rows into the f32 master and its bf16 shadow in place.
        (JAX copies here only because of buffer donation; on one CUDA
        stream the write is ordered after every queued read of the rows,
        so an in-place write is safe.)"""
        rows = torch.from_numpy(np.ascontiguousarray(block, np.float32)).to(self.device)
        n = rows.shape[0]
        self._gal[start : start + n] = rows
        self._gal16[start : start + n] = rows.to(torch.bfloat16)
        self._count_dev.fill_(start + n)

    def _flush_pending(self) -> None:
        """Write the host-buffered enrollments to the device in one copy
        (JAX pads the block to a bucket size to bound recompiles; eager
        PyTorch has none to bound)."""
        if not self._pending:
            return
        self._set_rows(self.count - len(self._pending), np.stack(self._pending))
        self._pending.clear()

    # -- persistence -------------------------------------------------------

    def _read(self, path: str) -> bytes:
        if self.encryptor:
            return self.encryptor.read_and_decrypt(path)
        with open(path, "rb") as f:
            return f.read()

    def _write(self, path: str, data: bytes) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"  # atomic replace: a crash leaves the old file whole
        if self.encryptor:
            self.encryptor.encrypt_and_write(tmp, data)
        else:
            with open(tmp, "wb") as f:
                f.write(data)
        os.replace(tmp, path)

    @property
    def _journal_path(self) -> Optional[str]:
        return self.index_path + ".journal" if self.index_path else None

    def _read_journal(self):
        """Yield (abs_row_index, label, db_id, vec) from the journal;
        raises on a malformed record.  Legacy index-less records replay
        sequentially and force a compaction."""
        path = self._journal_path
        if not path or not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        next_row = self._snapshot_rows
        while off < len(data):
            if off + 4 > len(data):
                raise ValueError("truncated journal record header")
            n = int.from_bytes(data[off : off + 4], "little")
            off += 4
            if off + n > len(data):
                raise ValueError("truncated journal record payload")
            payload = data[off : off + n]
            off += n
            if self.encryptor:
                payload = self.encryptor.decrypt_data(payload)
            rec = pickle.loads(payload)
            if isinstance(rec, dict):
                start, rows = int(rec["start"]), rec["rows"]
            elif isinstance(rec, (list, tuple)):
                self._force_compact = True
                start, rows = next_row, rec
            else:
                raise ValueError("unrecognized journal record type")
            for i, (label, db_id, blob) in enumerate(rows):
                vec = np.frombuffer(blob, np.float32)
                if vec.shape[0] != self.embedding_dim:
                    raise ValueError("journal row dim mismatch")
                yield start + i, label, int(db_id), vec
            next_row = max(next_row, start + len(rows))

    def _append_journal(self, rows, start_row: int) -> None:
        payload = pickle.dumps({
            "start": int(start_row),
            "rows": [(label, db_id, np.asarray(vec, np.float32).tobytes())
                     for label, db_id, vec in rows],
        })
        if self.encryptor:
            payload = self.encryptor.encrypt_data(payload)
        with open(self._journal_path, "ab") as f:
            f.write(len(payload).to_bytes(4, "little"))
            f.write(payload)

    def _load(self) -> None:
        try:
            mat = np.load(io.BytesIO(self._read(self.index_path)), allow_pickle=False)
            labels = pickle.loads(self._read(self.labels_path))
            db_ids = pickle.loads(self._read(self.db_ids_path))
            if mat.shape != (len(labels), self.embedding_dim):
                raise ValueError(f"index shape {mat.shape} != {len(labels)} labels")
            self.labels = list(labels)
            self.db_ids = list(db_ids)
            gal = np.zeros((self.padded, self.embedding_dim), np.float32)
            gal[: len(labels)] = mat
            self._snapshot_rows = len(labels)
            n_journal = 0
            for abs_idx, label, db_id, vec in self._read_journal():
                if abs_idx < self._snapshot_rows:
                    continue  # already compacted into the snapshot
                if abs_idx != self.count:
                    raise ValueError(f"journal discontinuity: row {abs_idx} vs count {self.count}")
                if self.count >= self.capacity:
                    break
                gal[self.count] = vec
                self.labels.append(label)
                self.db_ids.append(db_id)
                n_journal += 1
            self._journal_rows = n_journal
            self._reset_matrix(gal)
            self._fresh_host = []
            self._fresh_start = self.count
            log.info("Loaded gallery (%d identities: %d snapshot + %d journal) from disk.",
                     self.count, self._snapshot_rows, n_journal)
        except Exception as e:
            log.error("Error loading gallery index: %s", e)
            self.labels, self.db_ids = [], []
            self._reset_matrix()
            self._snapshot_rows = self._journal_rows = 0
            self._pending, self._fresh_host, self._fresh_start = [], [], 0
            self._force_compact = True
            log.info("Initialized a new gallery due to loading failure.")

    def save(self, compact: bool = False) -> None:
        """Persist: append new rows to the journal, or rewrite the
        snapshot when asked, when labels changed, when the journal is
        long, or when no snapshot exists yet."""
        if not (self.index_path and self.labels_path and self.db_ids_path):
            return
        persisted = self._snapshot_rows + self._journal_rows
        journal_after = self._journal_rows + (self.count - persisted)
        must_compact = (compact or self._labels_dirty or self._force_compact
                        or not os.path.exists(self.index_path)
                        or journal_after > self.journal_compact_threshold)
        if not must_compact:
            if self.count == persisted:
                return
            if persisted >= self._fresh_start:
                off = persisted - self._fresh_start
                fresh = self._fresh_host[off : off + (self.count - persisted)]
            else:
                self._flush_pending()
                fresh = self._gal[persisted : self.count].cpu().numpy()
            rows = [(self.labels[i], self.db_ids[i], fresh[i - persisted])
                    for i in range(persisted, self.count)]
            self._append_journal(rows, start_row=persisted)
            self._journal_rows += len(rows)
            return
        self._flush_pending()
        if self._fresh_start == 0 and len(self._fresh_host) >= self.count:
            mat = (np.stack(self._fresh_host[: self.count]) if self.count
                   else np.zeros((0, self.embedding_dim), np.float32))
        else:
            mat = self._gal[: self.count].cpu().numpy()
        buf = io.BytesIO()
        np.save(buf, mat, allow_pickle=False)
        self._write(self.index_path, buf.getvalue())
        self._write(self.labels_path, pickle.dumps(self.labels))
        self._write(self.db_ids_path, pickle.dumps(self.db_ids))
        jp = self._journal_path
        if jp and os.path.exists(jp):
            os.remove(jp)
        self._snapshot_rows = self.count
        self._journal_rows = 0
        self._labels_dirty = False
        self._force_compact = False
        self._fresh_host = []
        self._fresh_start = self.count

    # -- mutation ----------------------------------------------------------

    def add(self, embedding: np.ndarray, label: str, db_id: int) -> bool:
        """Append one identity; False at the capacity cap."""
        if self.count >= self.capacity:
            log.warning("Gallery has reached its maximum capacity. Cannot add more embeddings.")
            return False
        vec = np.asarray(embedding, np.float32).reshape(-1)
        n = np.linalg.norm(vec)
        if n > 0:
            vec = vec / n
        self._pending.append(vec)
        self._fresh_host.append(vec)
        self.labels.append(label)
        self.db_ids.append(int(db_id))
        return True

    def load_rows(self, rows) -> None:
        """Bulk hydrate from (db_id, label, blob) rows with
        re-normalisation; one host→device copy of the new rows."""
        vecs, labels, db_ids = [], [], []
        for db_id, label, blob in rows:
            emb = np.frombuffer(blob, np.float32)
            if emb.shape[0] != self.embedding_dim:
                log.warning("Embedding size mismatch for label '%s'. Skipping.", label)
                continue
            n = np.linalg.norm(emb)
            if n == 0:
                log.warning("Zero vector found for label '%s'. Skipping.", label)
                continue
            vecs.append(emb / n)
            labels.append(label)
            db_ids.append(int(db_id))
        if not vecs:
            return
        take = min(len(vecs), self.capacity - self.count)
        if take < len(vecs):
            log.warning("Gallery capacity cap: loading %d of %d rows.", take, len(vecs))
        self._flush_pending()
        start = self.count
        block = np.stack(vecs[:take])
        self._set_rows(start, block)
        self.labels.extend(labels[:take])
        self.db_ids.extend(db_ids[:take])
        if self._fresh_start + len(self._fresh_host) == start:
            self._fresh_host.extend(block)
        else:
            self._fresh_host = list(block)
            self._fresh_start = start

    # -- queries -----------------------------------------------------------

    def query(self, embedding: np.ndarray, k: int = 1):
        """(ids, cosine distances); (None, None) when empty."""
        return self.query_batch(np.asarray(embedding, np.float32).reshape(1, -1), k)

    def query_batch(self, embeddings: np.ndarray, k: int = 1):
        """Batched query: k=1 through K1 on the bf16 shadow; k>1 and
        strict matching through the plain top-k, taken ``QUERY_ROWS``
        queries at a time so that the (rows × padded capacity) float32
        similarity matrix stays bounded however many queries come
        (``shrink_db_ids`` sends one per gallery row)."""
        if self.count == 0:
            return None, None
        self._flush_pending()
        embeddings = np.ascontiguousarray(embeddings, np.float32)
        if k == 1 and not self.strict_f32_match:
            # the few queries of a frame go up without waiting for the card:
            # its two readbacks are the call's only waits, as in JAX
            q = self._staging.upload(embeddings, self.device)
            sims, idx = cosine_top1(q, self._gal16, self.count)
            return idx.cpu().numpy()[:, None], 1.0 - sims.cpu().numpy()[:, None]
        q = torch.from_numpy(embeddings).to(self.device)
        valid = torch.arange(self.padded, device=self.device) < self.count
        k = min(k, self.count)
        sims, idx = [], []
        for i in range(0, q.shape[0], self.QUERY_ROWS):
            rows = q[i : i + self.QUERY_ROWS]
            if self.strict_f32_match:
                s, j = cosine_topk_f32(rows, self._gal, valid, k)
            else:
                s, j = cosine_topk(rows, self._gal16, valid, k)
            sims.append(s.cpu().numpy())
            idx.append(j.cpu().numpy())
        return np.concatenate(idx), 1.0 - np.concatenate(sims)

    def find_similar(self, embedding: np.ndarray, threshold: float, k: int = 50) -> List[int]:
        """All ids with similarity ≥ threshold among the top min(k, count)."""
        if self.count == 0:
            return []
        ids, dists = self.query(embedding, k=min(k, self.count))
        return [int(i) for i, d in zip(ids[0], dists[0]) if 1.0 - d >= threshold]

    # -- relabel / unify ---------------------------------------------------

    def rename_single(self, gid: int, new_label: str, store) -> None:
        store.update_label(self.db_ids[gid], new_label)
        self.labels[gid] = new_label
        self._labels_dirty = True
        self.save()

    def unify_labels(self, gids: List[int], new_label: str, store, save: bool = True) -> None:
        """Rename a whole similar group in DB + memory."""
        store.update_labels([self.db_ids[g] for g in gids], new_label)
        for g in gids:
            self.labels[g] = new_label
        self._labels_dirty = True
        if save:
            self.save()

    def update_label(self, gid: int, new_label: str, store,
                     similarity_threshold: float = 0.7) -> None:
        """Group relabel with conflict refusal: unify all neighbours ≥
        threshold under ``new_label`` unless more than one distinct
        known (non-Unknown) label is present."""
        if gid < 0 or gid >= self.count:
            log.error("Invalid gallery id for update_label.")
            return
        ref = store.get_embedding(self.db_ids[gid])
        if ref is None:
            self.rename_single(gid, new_label, store)
            return
        similar = self.find_similar(ref, similarity_threshold, k=50)
        if not similar:
            self.rename_single(gid, new_label, store)
            return
        known = [self.labels[s] for s in similar if not self.labels[s].lower().startswith("unknown")]
        if len(set(known)) > 1:
            log.warning("Conflicting known labels found. Not unifying this group.")
            self.rename_single(gid, new_label, store)
            return
        self.unify_labels(similar, new_label, store)


class ShardedGalleryView:
    """A DeviceGallery's rows sharded over the mesh's ``dp`` axis
    (counterpart of ``fire_tpu.gallery.index.ShardedGalleryView``):
    queries take a local top-k on every shard and reduce the gathered
    candidates (:mod:`fire_tpu_torch.parallel.sharded_gallery`).

    The DeviceGallery stays the point of mutation (labels, SQLite);
    :meth:`refresh` brings the shards up to date after enrolments."""

    _BLOCK = 128  # incremental-refresh granularity (gallery.padded is a multiple)

    def __init__(self, gallery: DeviceGallery, mesh, axis: str = "dp"):
        self.gallery = gallery
        self.mesh = mesh
        self.axis = axis
        self._gal_sharded = None
        self._synced = 0  # gallery rows reflected in the shards
        self._staging = HostStaging()  # the queries' pinned upload buffers
        self.refresh()

    def refresh(self, force: bool = False) -> None:
        """Sync the shards with the gallery.  Enrolment appends rows, so
        the usual case copies only the 128-row blocks touched since the
        last sync, device to device; a full re-shard happens on the first
        build, a shrink (recovery rebuilt the gallery) or a change of the
        padded size.  No mask is kept: the query derives it per shard
        from the row count."""
        from fire_tpu_torch.parallel.sharded_gallery import shard_gallery, update_sharded_rows

        gal = self.gallery.gal_matmul  # the bf16 shadow: half the bytes per shard
        n = self.mesh.shape[self.axis]
        pad = _round_up(gal.shape[0], n)
        count = self.gallery.count
        if (force or self._gal_sharded is None or count < self._synced
                or len(self._gal_sharded) != n or self._gal_sharded[0].shape[0] * n != pad):
            if pad != gal.shape[0]:
                gal = torch.nn.functional.pad(gal, (0, 0, 0, pad - gal.shape[0]))
            self._gal_sharded = shard_gallery(self.mesh, gal, self.axis)
            self._synced = count
            return
        bk = self._BLOCK
        for bs in range((self._synced // bk) * bk, count, bk):
            # gallery.padded is a multiple of the block and count ≤ padded,
            # so every dirty block is whole and in range
            assert bs + bk <= gal.shape[0] <= pad
            update_sharded_rows(self._gal_sharded, gal[bs : bs + bk], bs)
        self._synced = count

    def query(self, embedding: np.ndarray, k: int = 1):
        """Single query (DeviceGallery.query's contract)."""
        return self.query_batch(np.asarray(embedding, np.float32).reshape(1, -1), k)

    @property
    def count(self) -> int:
        return self.gallery.count

    @property
    def labels(self):
        return self.gallery.labels

    def query_batch(self, embeddings: np.ndarray, k: int = 1):
        """DeviceGallery.query_batch's contract, sharded:
        ``(ids, 1 − sims)``, ``(None, None)`` when empty."""
        from fire_tpu_torch.parallel.sharded_gallery import sharded_cosine_topk

        count = self.gallery.count
        if count == 0:
            return None, None
        if count != self._synced:
            self.refresh()
        # the queries go up to the first shard's device without waiting for
        # it (JAX's device_put does not wait either): the two readbacks are
        # the call's only waits
        q = self._staging.upload(np.ascontiguousarray(embeddings, np.float32),
                                 self._gal_sharded[0].device)
        sims, idx = sharded_cosine_topk(self.mesh, q, self._gal_sharded, count,
                                        k=min(k, count), axis=self.axis)
        return idx.cpu().numpy(), 1.0 - sims.cpu().numpy()

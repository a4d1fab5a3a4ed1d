"""Durable write-ahead log + snapshot/compaction for the API server.

The port's copy of ``kubegpu_tpu/cluster/wal.py``, in the same file format:
a directory either package's server wrote, the other recovers.

The in-memory API server is fast but volatile: a restart used to lose
every object AND the watch event log, stranding every informer at a
sequence number the new process had never issued. This module makes the
event stream the unit of durability — every watch event ``(seq, kind,
event, obj)`` is one WAL record, so replaying the log rebuilds both the
object state (the events carry whole objects) and the exact watch-resume
cursor space.

Format (little-endian, one record per event):

    [4-byte payload length][4-byte CRC32 of payload][payload]
    payload = JSON [seq, kind, event, obj]

A torn tail — the process died mid-append — is detected by the length or
checksum and DROPPED, never fatal: the lost suffix was never
acknowledged to any client that matters (watch delivery happens after
the append returns).

Snapshot + compaction: every ``snapshot_every`` appends the server's
full object state is written to ``snapshot.json`` (tmp + fsync +
atomic rename) and the log truncated. Recovery loads the snapshot, then
replays any WAL records with a later sequence number; a crash between
snapshot and truncate is safe because replay skips records at or below
the snapshot's sequence. Clients that present a pre-snapshot ``since``
cannot be replayed exactly — the serving layer answers them with a
full-relist signal instead of a silent gap.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
import zlib
from typing import Any, BinaryIO, List, Optional, Tuple

from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.analysis.explore import probe

log = logging.getLogger(__name__)

_HEADER = struct.Struct("<II")  # payload length, CRC32(payload)

WAL_FILE = "wal.log"
SNAPSHOT_FILE = "snapshot.json"

# One WAL event record, exactly the watch-log tuple shape.
Record = Tuple[int, str, str, Any]


class WriteAheadLog:
    """Length-prefixed, checksummed WAL with periodic snapshot+compaction.

    ``fsync=False`` trades durability-to-media for speed (still durable
    across process crashes — the OS holds the page cache); benches and
    chaos scenarios use it, real deployments keep the default.
    """

    def __init__(self, dir_path: str, fsync: bool = True,
                 snapshot_every: int = 4096) -> None:
        self.dir_path = dir_path
        self.fsync = fsync
        self.snapshot_every = max(1, snapshot_every)
        os.makedirs(dir_path, exist_ok=True)
        self._lock = threading.Lock()
        self._fh: Optional[BinaryIO] = None
        self._closed = False
        self._since_snapshot = 0
        self.recovered_records = 0   # records the last recover() replayed
        self.dropped_tail_bytes = 0

    @property
    def wal_path(self) -> str:
        return os.path.join(self.dir_path, WAL_FILE)

    def stream_epoch(self) -> str:
        """Stable identity of this WAL's event stream, minted once per
        directory and persisted: a watch client uses it to tell "same
        stream, sequence continues" (WAL-backed restart) from "new
        stream that happens to have overlapping sequence numbers" (a
        different/wiped store) — the case a bare seq comparison cannot
        catch."""
        path = os.path.join(self.dir_path, "epoch")
        try:
            with open(path) as fh:
                return fh.read().strip()
        except FileNotFoundError:
            token = os.urandom(8).hex()
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                fh.write(token)
            os.replace(tmp, path)
            return token

    @property
    def snapshot_path(self) -> str:
        return os.path.join(self.dir_path, SNAPSHOT_FILE)

    # ---- append ------------------------------------------------------------

    @staticmethod
    def _encode(seq: int, kind: str, event: str, obj: Any) -> bytes:
        payload = json.dumps([seq, kind, event, obj],
                             separators=(",", ":"), default=str).encode()
        return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload

    def append(self, seq: int, kind: str, event: str, obj: Any) -> None:
        """Append one event record and make it durable (write + flush,
        plus fsync when enabled). Called by the event log BEFORE the
        event is served to any watcher — write-ahead, so anything a
        client saw is replayable."""
        probe("wal.append")
        data = self._encode(seq, kind, event, obj)
        t0 = time.perf_counter()
        with self._lock:
            fh = self._open_locked()
            fh.write(data)
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
            self._since_snapshot += 1
        metrics.WAL_FSYNC_MS.observe((time.perf_counter() - t0) * 1e3)

    def _open_locked(self) -> BinaryIO:
        # Always called with self._lock held.
        if self._closed:
            # close() latches: an in-flight mutator racing a server
            # shutdown must not quietly reopen the handle the shutdown
            # just released — its request fails instead (the client's
            # retry/reconnect layer owns what happens next)
            raise RuntimeError("write-ahead log is closed")
        if self._fh is None:
            self._fh = open(self.wal_path, "ab")
        return self._fh

    def due_for_snapshot(self) -> bool:
        with self._lock:
            return self._since_snapshot >= self.snapshot_every

    # ---- snapshot + compaction ---------------------------------------------

    def snapshot(self, state: Any, seq: int,
                 tail: Any = None) -> None:
        """Persist the full object state at ``seq`` and truncate the log.
        Ordering is what makes a crash at any point recoverable: the
        snapshot lands durably (tmp + fsync + atomic rename) BEFORE the
        WAL truncates, and recovery skips WAL records at or below the
        snapshot's sequence — so a crash between the two steps replays
        nothing twice and loses nothing. ``tail`` (recent event records
        already reflected in ``state``) rides along so the watch-resume
        window extends BELOW the compaction point: a client a few events
        behind the final pre-crash snapshot still resumes seq-exact
        instead of relisting."""
        doc = json.dumps({"seq": seq, "state": state,
                          "tail": list(tail or [])},
                         default=str).encode()
        tmp = self.snapshot_path + ".tmp"
        with self._lock:
            if self._closed:
                raise RuntimeError("write-ahead log is closed")
            with open(tmp, "wb") as fh:
                fh.write(doc)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.snapshot_path)
            if self._fh is not None:
                self._fh.close()
            self._fh = open(self.wal_path, "wb")  # truncate
            self._since_snapshot = 0
        metrics.WAL_SNAPSHOT_BYTES.set(len(doc))
        log.info("wal snapshot at seq %d (%d bytes); log compacted",
                 seq, len(doc))

    # ---- recovery ----------------------------------------------------------

    def load_snapshot(self) -> Tuple[int, Any, List[Record]]:
        """``(seq, state, tail)`` from the snapshot file, or
        ``(0, None, [])``."""
        try:
            with open(self.snapshot_path, "rb") as fh:
                doc = json.loads(fh.read().decode())
            tail = [(int(s), k, e, o)
                    for s, k, e, o in (doc.get("tail") or [])]
            return int(doc.get("seq", 0)), doc.get("state"), tail
        except FileNotFoundError:
            return 0, None, []
        except (ValueError, OSError):
            # a torn snapshot write never replaces the previous snapshot
            # (atomic rename), so a corrupt file here is pre-atomic-rename
            # debris or external damage: recover from the WAL alone
            log.warning("unreadable snapshot %s; recovering from the WAL "
                        "alone", self.snapshot_path, exc_info=True)
            return 0, None, []

    def read_records(self, after_seq: int = 0) -> List[Record]:
        """Decode WAL records with seq > ``after_seq``, truncating any
        torn tail in place (mid-append crash: the partial record was
        never acknowledged, dropping it is the correct recovery)."""
        records: List[Record] = []
        try:
            fh = open(self.wal_path, "rb")
        except FileNotFoundError:
            return records
        with fh:
            good_end = 0
            while True:
                header = fh.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    break
                length, crc = _HEADER.unpack(header)
                payload = fh.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    break
                try:
                    seq, kind, event, obj = json.loads(payload.decode())
                except ValueError:
                    break
                good_end = fh.tell()
                if seq > after_seq:
                    records.append((int(seq), kind, event, obj))
            end = fh.seek(0, os.SEEK_END)
            torn = end - good_end
        if torn > 0:
            self.dropped_tail_bytes += torn
            log.warning("wal: dropping %d torn tail byte(s) at offset %d",
                        torn, good_end)
            with open(self.wal_path, "r+b") as trunc:
                trunc.truncate(good_end)
        return records

    def recover(self, api: Any) -> Tuple[int, int, List[Record]]:
        """Rebuild ``api``'s state: snapshot first, then WAL replay.
        Returns ``(last_seq, floor, resume_records)`` for the event log:
        ``floor`` is the oldest sequence number still replayable
        (snapshot seq, lowered by the snapshot's retained event tail) —
        clients presenting an older ``since`` get a relist signal,
        everyone else resumes seq-exact from ``resume_records``. Tail
        records are already reflected in the snapshot state and are NOT
        re-applied — they only serve resume."""
        snap_seq, state, tail = self.load_snapshot()
        if state is not None:
            api.restore_state(state)
        floor = snap_seq
        if tail:
            floor = min(floor, tail[0][0] - 1)
        last_seq = snap_seq
        records = self.read_records(after_seq=snap_seq)
        for seq, kind, event, obj in records:
            try:
                api.restore_object(kind, event, obj)
            except Exception:
                # one unreplayable record must not void the rest of the
                # recovery — the object state it carried is skipped, the
                # sequence space stays intact
                log.warning("wal replay: could not restore %s %s record "
                            "seq %d", kind, event, seq, exc_info=True)
            last_seq = max(last_seq, seq)
        self.recovered_records = len(records)
        if records or state is not None:
            log.info("wal recovery: snapshot seq %d (+%d tail) + %d "
                     "replayed record(s) -> seq %d", snap_seq, len(tail),
                     len(records), last_seq)
        return last_seq, floor, tail + records

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is not None:
                self._fh.close()
                self._fh = None

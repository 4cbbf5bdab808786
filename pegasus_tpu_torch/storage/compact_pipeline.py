"""Staged bulk-compaction pipeline: read -> filter -> write, overlapped, as
in the JAX package's storage/compact_pipeline.py.

    READ thread    walks the L1 block entries in key order, reads the
                   raw/encoded block bytes (paced through the
                   CompactionGovernor token bucket), windows them
    FILTER thread  two-phase per window: submit the window's filter
                   launches (the compaction-filter kernel on the card;
                   encoded blocks with key-free rulesets evaluate on the
                   host off their raw predicate columns), then drain the
                   PREVIOUS window while this one evaluates
    WRITE (caller) the consuming generator feeds
                   LSMStore.bulk_compact_rewrite unchanged

Because the queues are FIFO and the stages preserve entry order, the
rewrite consumes the identical (block, drop-mask) stream the serial path
produces: pipelined output is byte-identical by construction.

Shutdown: any stage exception travels down the queues and re-raises in
the consumer; closing the consumer generator (writer failure) sets the
stop event, unblocks both queues, and joins the threads.

The stall counters and queue-depth gauges are the JAX package's node
metrics (`compact_{read,filter,write}_stall_ms`, `compact_readq_depth`,
`compact_filtq_depth` on the ("storage", "node") entity), and each
pipeline also keeps its own as attributes (`read_stall_ms`,
`filter_stall_ms`, `write_stall_ms`, `readq_depth`, `filtq_depth`);
the engine keeps its last pipeline (`StorageEngine.last_pipeline`).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Iterator, List, Optional, Sequence

from pegasus_tpu_torch.utils.flags import FLAGS, define_flag
from pegasus_tpu_torch.utils.metrics import METRICS

define_flag("pegasus.storage", "compact_pipeline", True,
            "overlap bulk compaction's block-read / filter-eval / "
            "write stages on dedicated threads with bounded queues; "
            "off = the serial windowed path (same output bytes either "
            "way)", mutable=True)
define_flag("pegasus.storage", "compact_pipeline_window", 128,
            "blocks per pipeline window (the unit the stages hand "
            "each other); bounds per-window memory and the filter "
            "batch size", mutable=True)
define_flag("pegasus.storage", "compact_pipeline_depth", 2,
            "windows each bounded inter-stage queue may hold — total "
            "in-flight memory is ~(2*depth + 2) windows", mutable=True)


def pipeline_enabled() -> bool:
    return bool(FLAGS.get("pegasus.storage", "compact_pipeline"))


def pipeline_window() -> int:
    return int(FLAGS.get("pegasus.storage", "compact_pipeline_window"))


def pipeline_depth() -> int:
    return int(FLAGS.get("pegasus.storage", "compact_pipeline_depth"))


def window_count(n_entries: int) -> int:
    """Windows a compaction over `n_entries` blocks submits: the host
    filter stage pays one launch a window, the unit the resident gate
    (ops/placement.mesh_compact_pays) weighs one whole-table round
    against."""
    return max(1, -(-int(n_entries) // max(1, pipeline_window())))


def transform_workers() -> int:
    """Write-stage transform pool size: the subset kernel / gather work
    per block runs GIL-free, so the pipelined rewrite keeps up to 4
    workers transforming ahead while the consumer thread appends in
    order."""
    return max(2, min(4, os.cpu_count() or 2))


def stage_threads_enabled() -> bool:
    """Dedicated read/filter stage threads pay only with 4+ cores: on a
    2-core host they fight the transform workers for the GIL."""
    return (os.cpu_count() or 2) >= 4


_ENT = METRICS.entity("storage", "node")
# stall = time a stage spent blocked on its neighbour's queue
_STALL_MS = {stage: _ENT.relaxed_counter(f"compact_{stage}_stall_ms")
             for stage in ("read", "filter", "write")}
_READQ_DEPTH = _ENT.gauge("compact_readq_depth")
_FILTQ_DEPTH = _ENT.gauge("compact_filtq_depth")

_END = object()


class _StageError:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


class CompactPipeline:
    """One pipelined bulk compaction.

    `load(entry)` runs on the READ thread per block entry;
    `submit(items)` / `drain(token)` run on the FILTER thread per window
    (submit launches without waiting, drain materializes — the pipeline
    keeps one window submitted ahead). The `results()` generator yields
    drained outputs in entry order on the caller's (write) thread.
    """

    def __init__(self, entries: Sequence, load: Callable,
                 submit: Callable[[List], object],
                 drain: Callable[[object], List],
                 window: int, depth: int = 2,
                 eager: Optional[Callable[[object], bool]] = None
                 ) -> None:
        self._entries = entries
        self._load = load
        self._submit = submit
        self._drain = drain
        # eager(token) True = this window has no asynchronously
        # evaluating leg (all masks were computed at submit): drain and
        # forward it immediately instead of holding the lookahead
        self._eager = eager or (lambda _t: False)
        self._window = max(1, window)
        self._stop = threading.Event()
        self._q_read: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._q_filt: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        # stall = time a stage spent blocked on its neighbour's queue
        self.read_stall_ms = 0
        self.filter_stall_ms = 0
        self.write_stall_ms = 0
        self.readq_depth = 0
        self.filtq_depth = 0

    def _stall(self, stage: str, waited: float) -> None:
        # each stage counts on its own thread: no two writers a counter
        name = f"{stage}_stall_ms"
        setattr(self, name, getattr(self, name) + int(waited * 1000))
        _STALL_MS[stage].increment(int(waited * 1000))

    # ---- bounded-queue helpers that honor the stop event ---------------

    def _put(self, q: "queue.Queue", item, stage: str) -> bool:
        t0 = time.perf_counter()
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.05)
                waited = time.perf_counter() - t0
                if waited > 0.001:
                    self._stall(stage, waited)
                return True
            except queue.Full:
                continue
        return False

    def _get(self, q: "queue.Queue", stage: str):
        t0 = time.perf_counter()
        while not self._stop.is_set():
            try:
                item = q.get(timeout=0.05)
                waited = time.perf_counter() - t0
                if waited > 0.001:
                    self._stall(stage, waited)
                return item
            except queue.Empty:
                continue
        return _END

    # ---- stages ---------------------------------------------------------

    def _read_stage(self) -> None:
        try:
            w = self._window
            for off in range(0, len(self._entries), w):
                if self._stop.is_set():
                    return
                items = [self._load(e)
                         for e in self._entries[off:off + w]]
                self.readq_depth = self._q_read.qsize()
                _READQ_DEPTH.set(self.readq_depth)
                if not self._put(self._q_read, items, "read"):
                    return
            self._put(self._q_read, _END, "read")
        except BaseException as e:  # noqa: BLE001 - travels to consumer
            self._put(self._q_read, _StageError(e), "read")

    def _filter_stage(self) -> None:
        pending = None
        try:
            while not self._stop.is_set():
                items = self._get(self._q_read, "filter")
                if isinstance(items, _StageError):
                    if pending is not None:
                        self._put(self._q_filt, self._drain(pending),
                                  "filter")
                        pending = None
                    self._put(self._q_filt, items, "filter")
                    return
                if items is _END:
                    break
                token = self._submit(items)
                if pending is not None:
                    self.filtq_depth = self._q_filt.qsize()
                    _FILTQ_DEPTH.set(self.filtq_depth)
                    if not self._put(self._q_filt, self._drain(pending),
                                     "filter"):
                        return
                    pending = None
                if self._eager(token):
                    if not self._put(self._q_filt, self._drain(token),
                                     "filter"):
                        return
                else:
                    pending = token
            if pending is not None and not self._stop.is_set():
                self._put(self._q_filt, self._drain(pending), "filter")
            self._put(self._q_filt, _END, "filter")
        except BaseException as e:  # noqa: BLE001 - travels to consumer
            self._put(self._q_filt, _StageError(e), "filter")

    # ---- consumer --------------------------------------------------------

    def results(self) -> Iterator:
        """Yield (entry-order) filter outputs; re-raises any stage
        failure. Closing the generator stops and joins the stages."""
        t_read = threading.Thread(target=self._read_stage,
                                  name="compact-read", daemon=True)
        t_filt = threading.Thread(target=self._filter_stage,
                                  name="compact-filter", daemon=True)
        t_read.start()
        t_filt.start()
        try:
            while True:
                outs = self._get(self._q_filt, "write")
                if outs is _END:
                    return
                if isinstance(outs, _StageError):
                    raise outs.exc
                yield from outs
        finally:
            self._stop.set()
            # unblock producers stuck on a full queue, then join — the
            # threads must not outlive the compaction that owns the run
            # handles they read from
            for q in (self._q_read, self._q_filt):
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
            t_read.join(timeout=5.0)
            t_filt.join(timeout=5.0)

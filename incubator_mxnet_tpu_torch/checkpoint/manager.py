"""CheckpointManager: the user-facing elastic checkpointing handle.

PyTorch port of `incubator_mxnet_tpu/checkpoint/manager.py`.

One manager per checkpoint directory owns the async writer, retention,
and resume.  ``snapshot()`` stages training state into pooled host
buffers and returns while a background thread serializes and atomically
commits the checkpoint (see `snapshot.py`); ``flush()`` waits for the
in-flight write; ``load_latest()`` returns the newest checkpoint whose
manifest and shard checksums verify.  ``install_preemption_hook`` wires
a SIGTERM handler that takes one final SYNCHRONOUS snapshot when the
scheduler serves an eviction notice, then exits.

Dist layout (``kvstore='dist_*'``): rank 0 writes params + manifest and
owns the atomic commit; every other rank publishes its shard into
``<dir>/rank-shards/`` where rank 0's next commit adopts it (so a torn
multi-rank write is still invisible to ``latest()``).
"""
from __future__ import annotations

import os
import pickle
import signal

from ..base import MXNetError
from . import manifest as _manifest
from . import snapshot as _snapshot
from . import state as _state

__all__ = ["CheckpointManager", "CheckpointData", "latest", "load",
           "install_preemption_hook"]


class CheckpointData:
    """One loaded checkpoint: host arrays, raw blobs, and the manifest."""

    def __init__(self, path, manifest, arrays, blobs):
        self.path = path
        self.manifest = manifest
        self.step = int(manifest.get("step", 0))
        self.epoch = int(manifest.get("epoch", 0))
        self.nbatch = int(manifest.get("nbatch", 0))
        self.rng = manifest.get("rng")
        self.meta = manifest.get("meta", {})
        self.arrays = arrays      # {name: np.ndarray}
        self.blobs = blobs        # {name: bytes} (shard stem -> contents)

    def rank_shard(self, rank):
        """The payload dict ({'arrays', 'blobs', 'rng'}) a given rank
        published for this step, or None when that rank's shard did not
        make this commit (a lagging rank — its state falls back to
        position-only resume)."""
        blob = self.blobs.get("step-%d-rank-%d" % (self.step, int(rank)))
        if blob is None:
            return None
        return pickle.loads(blob)


def latest(root, deep=True, include_rejected=False):
    """Newest VALID checkpoint directory under `root`, or None (torn
    checkpoints never selected — see `manifest.validate`; canary-
    rejected ones skipped unless `include_rejected`)."""
    return _manifest.latest(root, deep=deep,
                            include_rejected=include_rejected)


def load(path):
    """Read one checkpoint directory back into host memory."""
    if not _manifest.validate(path):
        raise MXNetError(f"{path}: not a valid checkpoint (torn write or "
                         "corrupt shard)")
    manifest = _manifest.read_manifest(path)
    arrays, blobs = {}, {}
    for name in manifest.get("shards", {}):
        fpath = os.path.join(path, name)
        if name == _snapshot.ARRAYS_SHARD:
            arrays = _snapshot.read_array_shard(fpath)
        else:
            stem = name[:-4] if name.endswith(".bin") else name
            with open(fpath, "rb") as f:
                blobs[stem] = f.read()
    return CheckpointData(path, manifest, arrays, blobs)


class CheckpointManager:
    def __init__(self, directory, keep_last=5, async_snapshots=True,
                 rank=0, num_ranks=1):
        self.directory = str(directory)
        self.keep_last = int(keep_last)
        self.async_snapshots = bool(async_snapshots)
        self.rank = int(rank)
        self.num_ranks = int(num_ranks)
        self._writer = _snapshot.SnapshotWriter()
        self._preemption_capture = None
        self._uninstall_hook = None
        self.preempt_requested = False
        self.preempt_exit_code = 143
        os.makedirs(self.directory, exist_ok=True)
        if self.rank == 0:
            # one full sweep at construction clears a prior run's torn
            # directories; steady-state retention is then O(1) per commit
            # (see _retire) — a full rescan per snapshot costs real wall
            # time on metadata-slow filesystems
            _manifest.gc(self.directory, self.keep_last)
            self._committed = [path for _, path in
                               _manifest.list_checkpoints(
                                   self.directory, valid_only=True,
                                   deep=False)]
        else:
            self._committed = []

    def _retire(self, committed_path):
        """Called by the background writer after each commit: returns the
        directories that just fell off the retention window."""
        if committed_path in self._committed:
            return []
        self._committed.append(committed_path)
        stale, self._committed = (self._committed[:-self.keep_last],
                                  self._committed[-self.keep_last:])
        return stale

    # -- writing ---------------------------------------------------------------
    def snapshot(self, arrays=None, blobs=None, step=0, epoch=0, nbatch=0,
                 meta=None, include_rng=True, sync=False, staged=()):
        """Stage a checkpoint and hand it to the background writer.

        `arrays` values may be NDArrays, tensors or numpy arrays; copies
        into pooled host buffers are queued BEFORE this returns (on the
        current stream, for tensors on the card), so the caller may keep
        training, and updating the originals in place, while the write is
        in flight.  `blobs` are bytes, or callables the writer calls for
        them, one shard file each; `staged` lists the `snapshot.Staged`
        sets such callables read, released with the job's own.
        ``sync=True`` waits for the commit (the preemption path).
        """
        own = _snapshot.gather_to_pool(arrays or {})
        # every rank's RNG streams are rank-local state: rank 0's ride the
        # manifest, other ranks' ride their shard payload
        rng = _state.capture_rng() if include_rng else None
        job = _snapshot.SnapshotJob(
            self.directory, step=step, epoch=epoch, nbatch=nbatch,
            arrays=own.arrays, blobs=blobs, rng=rng, meta=meta,
            retire=self._retire if self.rank == 0 else None,
            rank=self.rank, num_ranks=self.num_ranks,
            staged=[own] + list(staged))
        if self.async_snapshots and not sync:
            self._writer.submit(job)
        else:
            self._writer.submit(job, sync=True)
        return job.step

    def flush(self):
        """Wait until no snapshot is in flight (checkpoint `waitall()`)."""
        self._writer.flush()

    def close(self):
        self.uninstall_preemption_hook()
        self._writer.close()

    # -- reading ---------------------------------------------------------------
    def latest(self):
        return latest(self.directory)

    def load_latest(self):
        path = self.latest()
        return load(path) if path is not None else None

    # -- preemption ------------------------------------------------------------
    def install_preemption_hook(self, signals=("SIGTERM",), exit_code=143):
        """Arm SIGTERM (by default) to REQUEST preemption: the handler
        only sets `preempt_requested`; the training loop observes it at
        the next batch boundary, takes one final SYNCHRONOUS snapshot
        there, and exits with `exit_code` (`honor_preemption`).

        The two-phase protocol exists for consistency: a signal lands
        between arbitrary bytecodes, where the loop's (epoch, batch,
        step) bookkeeping can lag the already-updated parameters —
        snapshotting directly from the handler would capture a position
        the params have moved past, and resume would replay applied
        batches.  At a batch boundary state and position agree.

        Returns an uninstall callable; no-op off the main thread
        (CPython restricts signal handlers to it)."""
        if self._uninstall_hook is not None:
            return self._uninstall_hook
        self.preempt_exit_code = exit_code

        def request():
            self.preempt_requested = True

        try:
            self._uninstall_hook = install_preemption_hook(
                request, signals=signals, exit_code=None)
        except (ValueError, OSError):  # not the main thread / no signals
            self._uninstall_hook = None
        return self._uninstall_hook

    def honor_preemption(self, capture):
        """Called by training loops at a consistent boundary when
        `preempt_requested` is set: run `capture()` (which must snapshot
        synchronously), then exit with the armed exit code.

        Best-effort by design: a deferred error from an EARLIER async
        write (submit/flush re-raise those) must not cost the final
        snapshot — the first attempt clears the stale error, so one retry
        gets a clean writer; and whatever happens, the process still
        exits with the code the scheduler keys on."""
        if not self.preempt_requested:
            return
        try:
            try:
                capture()
            except MXNetError:
                capture()   # stale background-write error cleared above
            self.flush()
        except BaseException:
            import logging
            logging.getLogger(__name__).exception(
                "final preemption snapshot failed; exiting anyway — "
                "resume will use the last committed checkpoint")
            if self.preempt_exit_code is None:
                raise
        finally:
            if self.preempt_exit_code is not None:
                os._exit(self.preempt_exit_code)
        self.preempt_requested = False

    def uninstall_preemption_hook(self):
        if self._uninstall_hook is not None:
            self._uninstall_hook()
            self._uninstall_hook = None


def install_preemption_hook(capture, signals=("SIGTERM",), exit_code=143):
    """Run ``capture()`` when a preemption signal lands, then exit with
    `exit_code` (143 = 128+SIGTERM, the conventional code
    preemption-aware schedulers expect; None = return to the program).
    The previous handler is restored by the returned uninstall callable.
    Must be called from the main thread.

    Standalone users: `capture` runs INSIDE the signal handler, between
    two arbitrary bytecodes of whatever was executing — only use this
    directly when the captured state is consistent at every bytecode.
    Training loops should go through `CheckpointManager`'s two-phase
    request/honor protocol instead (see `install_preemption_hook` on the
    manager)."""
    sigs = []
    for s in signals:
        sigs.append(getattr(signal, s) if isinstance(s, str) else s)

    def handler(signum, frame):
        try:
            capture()
        finally:
            if exit_code is not None:
                # handlers run between bytecodes of the main thread: the
                # capture above fully committed, so a hard exit is safe
                # and beats unwinding through arbitrary training code
                os._exit(exit_code)

    previous = {s: signal.signal(s, handler) for s in sigs}

    def uninstall():
        for s, prev in previous.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError, OSError):
                pass
    return uninstall

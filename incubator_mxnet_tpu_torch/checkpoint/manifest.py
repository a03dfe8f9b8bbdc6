"""Atomic checkpoint manifests.

A checkpoint is a DIRECTORY of shard files plus a ``manifest.json``
recording step/epoch/RNG state, the framework version, and a byte count +
CRC32 per shard.  Two rules make a checkpoint impossible to mistake for
valid when its writer died mid-flight:

* shards are written into a hidden temp directory which is renamed into
  place with ``os.replace`` only after every shard landed — the commit is
  one rename;
* the manifest itself is written temp-file + ``os.replace`` and is the
  LAST file written, and ``validate`` re-checks every shard's size and
  checksum against it — so even a checkpoint assembled in place (the
  per-rank dist layout) is only trusted once it is internally consistent.

``latest``/``list_checkpoints`` only ever surface directories that pass
``validate``; a torn write is garbage-collected, never resumed from.

A copy of `incubator_mxnet_tpu/checkpoint/manifest.py` (pure Python; the
port keeps its own copy).  The format string is the JAX package's, so a
checkpoint directory either package wrote validates and loads in the
other; ``framework_version`` names the writer.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib

from ..base import MXNetError

MANIFEST_NAME = "manifest.json"
REJECTED_STAMP_NAME = "rejected.json"
CHECKPOINT_FORMAT = "incubator_mxnet_tpu.checkpoint/1"
_CKPT_RE = re.compile(r"^ckpt-(\d+)$")
_TMP_PREFIX = ".tmp-ckpt-"
FRAMEWORK_VERSION = "incubator_mxnet_tpu_torch 0.1.0"


def checkpoint_dirname(step):
    return "ckpt-%010d" % int(step)


def file_crc32(path, chunk_size=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def atomic_write_json(path, obj):
    """Write JSON so a killed writer leaves either the old file or the new
    one, never a torn hybrid (temp file + ``os.replace``).  No fsync on
    the hot path: a torn manifest after power loss fails ``validate`` and
    resume falls back one checkpoint — the checksum gate, not the disk
    cache, is the integrity contract (fsync per snapshot would serialize
    the train loop against disk latency)."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def shard_entry(path):
    """Manifest entry for one shard file: size + CRC32 of its bytes."""
    return {"bytes": os.path.getsize(path), "crc32": file_crc32(path)}


def write_manifest(ckpt_dir, *, step, epoch=0, nbatch=0, shards=None,
                   rng=None, meta=None, num_ranks=1):
    manifest = {
        "format": CHECKPOINT_FORMAT,
        "framework_version": FRAMEWORK_VERSION,
        "step": int(step),
        "epoch": int(epoch),
        "nbatch": int(nbatch),
        "num_ranks": int(num_ranks),
        "shards": shards or {},
        "rng": rng,
        "meta": meta or {},
    }
    atomic_write_json(os.path.join(ckpt_dir, MANIFEST_NAME), manifest)
    return manifest


def read_manifest(ckpt_dir):
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("format") != CHECKPOINT_FORMAT:
        raise MXNetError(
            f"{path}: unknown checkpoint format {manifest.get('format')!r}")
    return manifest


def validate(ckpt_dir, deep=True):
    """Whether `ckpt_dir` holds a complete, uncorrupted checkpoint.

    Shallow: manifest parses and every listed shard file exists with the
    recorded byte count.  Deep (default) additionally re-hashes each
    shard against its recorded CRC32 — the contract `latest()` relies on:
    a half-written shard or a bit-flipped file is never selected.
    """
    try:
        manifest = read_manifest(ckpt_dir)
    except (OSError, ValueError, MXNetError):
        return False
    for name, entry in manifest.get("shards", {}).items():
        path = os.path.join(ckpt_dir, name)
        try:
            if os.path.getsize(path) != int(entry["bytes"]):
                return False
            if deep and file_crc32(path) != int(entry["crc32"]):
                return False
        except (OSError, KeyError, ValueError, TypeError):
            return False
    return True


def stamp_rejected(ckpt_dir, reason="", **info):
    """Stamp a checkpoint rejected — a sidecar file, not a manifest edit.

    Written by the serving-side canary gate (loop/controller.py) when a
    published version fails its holdout canary: the checkpoint stays on
    disk (forensics, gc retention) but `latest()`/`latest_healthy()`
    skip it from then on, so neither trainer resume nor a freshly booted
    replica can ever select it again.  Idempotent: the FIRST stamp wins
    and later calls return it unchanged — the original rejection
    evidence (scores, reason) is never overwritten.  Being a plain file,
    the stamp survives process restart.
    """
    path = os.path.join(ckpt_dir, REJECTED_STAMP_NAME)
    existing = rejection(ckpt_dir)
    if existing is not None:
        return existing
    rec = {"rejected": True, "reason": str(reason)}
    rec.update(info)
    atomic_write_json(path, rec)
    return rec


def rejection(ckpt_dir):
    """The rejection stamp of `ckpt_dir`, or None if not stamped."""
    try:
        with open(os.path.join(ckpt_dir, REJECTED_STAMP_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def is_rejected(ckpt_dir):
    return rejection(ckpt_dir) is not None


def _excluded(step, path, exclude):
    """Whether `exclude` — a callable(step)->bool or a collection of
    steps and/or paths — blocks this checkpoint."""
    if exclude is None:
        return False
    if callable(exclude):
        return bool(exclude(step))
    return step in exclude or path in exclude


def list_checkpoints(root, valid_only=True, deep=True,
                     include_rejected=True):
    """Sorted [(step, path)] of checkpoints under `root` (oldest first)."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        m = _CKPT_RE.match(name)
        if not m:
            continue
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        if valid_only and not validate(path, deep=deep):
            continue
        if not include_rejected and is_rejected(path):
            continue
        out.append((int(m.group(1)), path))
    out.sort()
    return out


def latest(root, deep=True, include_rejected=False):
    """Path of the newest VALID checkpoint under `root`, or None.

    Torn checkpoints — missing/corrupt manifest, truncated shard, bad
    checksum — are skipped, so resume always lands on the last write that
    fully committed.  Canary-rejected checkpoints (see `stamp_rejected`)
    are skipped by default: a version the serving fleet refused must not
    come back through resume or replica boot.
    """
    ckpts = list_checkpoints(root, valid_only=True, deep=deep,
                             include_rejected=include_rejected)
    return ckpts[-1][1] if ckpts else None


def latest_healthy(root, max_step=None, deep=True, exclude=None):
    """Path of the newest VALID checkpoint stamped healthy, or None.

    The training guardian (resilience/guardian.py) stamps every
    manifest's ``meta.health``; rollback-to-last-good selects with this:
    checkpoints stamped ``suspect`` (taken inside an active anomaly) are
    passed over, and ``max_step`` bounds the search to snapshots at or
    before the last known-good step — the newest checkpoint may already
    carry a loss spike's damage.  Manifests without a stamp (pre-
    guardian, foreign writers) count as healthy.

    Canary-rejected checkpoints are always skipped.  ``exclude`` narrows
    further: a callable(step)->bool, or a collection of steps/paths —
    the train-to-serve publisher passes the registry's fence windows
    here so a guardian-fenced step is never re-published.
    """
    for step, path in reversed(list_checkpoints(root, valid_only=True,
                                                deep=deep,
                                                include_rejected=False)):
        if max_step is not None and step > int(max_step):
            continue
        if _excluded(step, path, exclude):
            continue
        try:
            manifest = read_manifest(path)
        except (OSError, ValueError, MXNetError):
            continue
        health = (manifest.get("meta") or {}).get("health") or {}
        if health.get("status", "healthy") == "healthy":
            return path
    return None


def gc(root, keep_last):
    """Retention: drop all but the newest `keep_last` VALID checkpoints,
    plus any torn directory older than the newest valid one (a torn dir
    NEWER than it may be a concurrent writer mid-commit — left alone)."""
    keep_last = max(1, int(keep_last))
    valid = list_checkpoints(root, valid_only=True, deep=False)
    removed = []
    for _, path in valid[:-keep_last] if len(valid) > keep_last else []:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    newest_step = valid[-1][0] if valid else None
    try:
        names = os.listdir(root)
    except OSError:
        return removed
    for name in names:
        path = os.path.join(root, name)
        m = _CKPT_RE.match(name)
        torn = (m and os.path.isdir(path) and newest_step is not None and
                int(m.group(1)) < newest_step and not validate(path,
                                                               deep=False))
        # a temp dir for a step older than the newest commit can only be a
        # dead writer's leftovers; a newer one may be a live writer mid-build
        tm = re.match(re.escape(_TMP_PREFIX) + r"(\d+)-", name)
        stale_tmp = (tm and newest_step is not None and
                     int(tm.group(1)) < newest_step)
        if torn or (stale_tmp and os.path.isdir(path)):
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    return removed

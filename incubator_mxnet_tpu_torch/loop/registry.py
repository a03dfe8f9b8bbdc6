"""Versioned model registry — the train-to-serve hand-off directory.

PyTorch port of `incubator_mxnet_tpu/loop/registry.py`: the same layout
and record format (``incubator_mxnet_tpu.registry/1``), so either
package reads the versions, fences and rejection stamps the other wrote.

The trainer's `CheckpointPublisher` (publisher.py) writes one manifest
per published version into a shared directory; the serving fleet's
`LoopController` (controller.py) polls the same directory.  Three rules
make the hand-off safe across processes and hosts that share nothing but
this directory:

* a version manifest is written temp-file + ``os.replace`` — readers see
  either the whole manifest or none of it; any file that does not parse
  as a stamped ``incubator_mxnet_tpu.registry/1`` record is INVISIBLE
  (counted, never surfaced), so a torn publish can never be picked up;
* a ``rejected`` stamp is a sidecar file, not a manifest edit — stamping
  is idempotent (first stamp wins), survives process restart, and hides
  the version from every reader from then on, so a canary-rejected
  version is never retried;
* a ``fence`` record hides a whole step window — the trainer writes one
  when the guardian rolls back or training diverges, so versions
  published from a contaminated window disappear from readers even if
  their manifests landed before the anomaly was detected.

Registry layout (all JSON, all atomic)::

    registry/
      v-0000000120.json           # version manifest (version == step)
      v-0000000120.rejected.json  # canary-rejection stamp (sidecar)
      fence-0000000121-0000000160.json   # contaminated window [lo, hi]
      blobs/v-0000000120/         # pinned checkpoint (publish(pin=True))

A missing registry root raises a structured `RegistryUnavailableError`
rather than returning "no versions": the watcher must distinguish "no
new model yet" (keep polling) from "storage is gone" (keep serving the
incumbent and alarm).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time

from ..base import MXNetError
from ..checkpoint.manifest import atomic_write_json
from ..resilience import faults as _faults

REGISTRY_FORMAT = "incubator_mxnet_tpu.registry/1"
_VERSION_RE = re.compile(r"^v-(\d+)\.json$")
_REJECT_RE = re.compile(r"^v-(\d+)\.rejected\.json$")
_FENCE_RE = re.compile(r"^fence-(\d+)-(\d+)\.json$")


class RegistryUnavailableError(MXNetError):
    """The registry directory is gone or unreadable mid-poll.

    Carries ``root`` so the watcher can alarm on the exact path; the
    correct response on the serving side is to keep the incumbent live
    and retry on the next poll, never to tear anything down.
    """

    def __init__(self, root, detail=""):
        self.root = root
        super().__init__(
            f"model registry unavailable at '{root}'"
            + (f": {detail}" if detail else ""))


def _version_name(version):
    return "v-%010d.json" % int(version)


def _reject_name(version):
    return "v-%010d.rejected.json" % int(version)


def _fence_name(lo, hi):
    return "fence-%010d-%010d.json" % (int(lo), int(hi))


class ModelRegistry:
    """Reader/writer for one registry directory.

    Stateless between calls — every read re-lists the directory, so
    multiple processes (trainer, N serving hosts) can share one root
    with no coordination beyond the filesystem's atomic rename.
    """

    def __init__(self, root, create=True):
        self.root = str(root)
        if create:
            os.makedirs(self.root, exist_ok=True)
        self._torn_seen = 0

    # ------------------------------------------------------------- write
    def publish(self, checkpoint, *, step, health=None, watermark=None,
                score=None, meta=None, pin=False):
        """Publish one version (version number == trained step).

        With ``pin=True`` the checkpoint directory is first hardlinked
        (copy fallback) into ``registry/blobs/`` and the version record
        points at that registry-owned copy — the published weights then
        outlive the trainer's own checkpoint retention, which prunes
        old ``ckpt-*`` directories on its own schedule.

        Fires the ``publish.commit`` fault site; a ``torn`` clause there
        emulates the publisher dying mid-rename by leaving a TRUNCATED
        manifest under the final name — the exact garbage readers must
        treat as invisible — and re-raises `TornWrite` so the caller
        knows the publish did not commit.
        """
        self._require_root()
        source = str(checkpoint)
        if pin:
            checkpoint = self._pin_checkpoint(checkpoint, step)
        rec = {
            "format": REGISTRY_FORMAT,
            "version": int(step),
            "step": int(step),
            "checkpoint": str(checkpoint),
            # the trainer-side directory the pin was taken from: a
            # canary rejection must stamp THAT path too, or resume /
            # replica boot scanning the trainer's checkpoint_dir (not
            # the registry blobs/) would never see the verdict
            "source_checkpoint": source,
            "health": dict(health or {}),
            "watermark": dict(watermark or {}),
            "score": score,
            "meta": dict(meta or {}),
            "published_unix": time.time(),
        }
        path = os.path.join(self.root, _version_name(step))
        try:
            _faults.fire("publish.commit", version=int(step))
        except _faults.TornWrite:
            blob = json.dumps(rec, indent=1, sort_keys=True)
            with open(path, "w") as f:
                f.write(blob[:max(1, len(blob) // 2)])
            raise
        atomic_write_json(path, rec)
        return rec

    def reject(self, version, reason="", **info):
        """Stamp `version` rejected — idempotent, first stamp wins.

        The stamp is a sidecar file so it survives a re-publish of the
        same version (the manifest may be atomically replaced; the stamp
        stays) and a process restart (it is on disk, not in memory).
        """
        self._require_root()
        path = os.path.join(self.root, _reject_name(version))
        existing = self._read_json(path)
        if existing is not None:
            return existing
        rec = {"version": int(version), "rejected": True,
               "reason": str(reason), "rejected_unix": time.time()}
        rec.update(info)
        atomic_write_json(path, rec)
        return rec

    def fence(self, lo_step, hi_step, reason=""):
        """Hide every version with lo_step <= version <= hi_step.

        Written by the trainer when the guardian rolls back (the window
        between the last good step and the detected anomaly trained on
        data it has now disowned) or when training diverges outright.
        """
        self._require_root()
        lo, hi = int(lo_step), int(hi_step)
        if hi < lo:
            lo, hi = hi, lo
        rec = {"lo": lo, "hi": hi, "reason": str(reason),
               "fenced_unix": time.time()}
        atomic_write_json(os.path.join(self.root, _fence_name(lo, hi)), rec)
        return rec

    # -------------------------------------------------------------- read
    def versions(self, include_rejected=False, include_fenced=False):
        """Sorted (oldest first) list of visible version records.

        Each record is annotated with ``rejected``/``fenced`` booleans;
        torn or unstamped manifests are never surfaced (counted in
        `stats()["torn_manifests"]`).
        """
        names = self._listdir()
        rejected = set()
        for name in names:
            m = _REJECT_RE.match(name)
            if m:
                rejected.add(int(m.group(1)))
        fences = self._fences(names)
        out, torn = [], 0
        for name in names:
            m = _VERSION_RE.match(name)
            if not m:
                continue
            rec = self._read_json(os.path.join(self.root, name))
            if (rec is None or rec.get("format") != REGISTRY_FORMAT
                    or not isinstance(rec.get("version"), int)):
                torn += 1
                continue
            v = rec["version"]
            rec = dict(rec)
            rec["rejected"] = v in rejected
            rec["fenced"] = any(lo <= v <= hi for lo, hi in fences)
            if rec["rejected"] and not include_rejected:
                continue
            if rec["fenced"] and not include_fenced:
                continue
            out.append(rec)
        self._torn_seen = torn
        out.sort(key=lambda r: r["version"])
        return out

    def latest(self, **kw):
        """Newest visible (not rejected, not fenced, not torn) version."""
        recs = self.versions(**kw)
        return recs[-1] if recs else None

    def get(self, version):
        """The visible record for `version`, or None."""
        for rec in self.versions(include_rejected=True, include_fenced=True):
            if rec["version"] == int(version):
                return rec
        return None

    def rejected(self, version):
        """The rejection stamp for `version`, or None."""
        if not os.path.isdir(self.root):
            raise RegistryUnavailableError(self.root)
        return self._read_json(
            os.path.join(self.root, _reject_name(version)))

    def fenced(self, version):
        """Whether `version` falls inside any fence window."""
        return any(lo <= int(version) <= hi
                   for lo, hi in self._fences(self._listdir()))

    def fences(self):
        """Sorted [(lo, hi)] fence windows."""
        return self._fences(self._listdir())

    # surfaced through the 'loop' / 'loop.publisher' producers — a
    # registry is a stateless per-call reader, often several per
    # process, so it has no stable namespace of its own
    def stats(self):
        try:
            recs = self.versions(include_rejected=True, include_fenced=True)
        except RegistryUnavailableError:
            return {"available": 0}
        visible = [r for r in recs if not r["rejected"] and not r["fenced"]]
        return {
            "available": 1,
            "versions": len(recs),
            "visible": len(visible),
            "rejected": sum(r["rejected"] for r in recs),
            "fenced": sum(r["fenced"] for r in recs),
            "torn_manifests": self._torn_seen,
            "latest_version": visible[-1]["version"] if visible else -1,
        }

    # --------------------------------------------------------- internals
    def _pin_checkpoint(self, src, step):
        """Hardlink (copy fallback) `src` into ``blobs/v-<step>/``.

        Published versions must outlive the trainer's own checkpoint
        retention (fit prunes old ``ckpt-*`` dirs); pinning gives the
        registry its own reference.  Idempotent: an existing pin wins,
        including against a concurrent publisher racing the rename.
        """
        dst = os.path.join(self.root, "blobs", "v-%010d" % int(step))
        if os.path.isdir(dst):
            return dst
        tmp = dst + ".tmp.%d" % os.getpid()
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name in sorted(os.listdir(src)):
            s, d = os.path.join(src, name), os.path.join(tmp, name)
            if os.path.isdir(s):
                shutil.copytree(s, d)
                continue
            try:
                os.link(s, d)
            except OSError:
                shutil.copy2(s, d)
        try:
            os.rename(tmp, dst)
        except OSError:
            # a concurrent publisher pinned the same version first
            shutil.rmtree(tmp, ignore_errors=True)
        return dst

    def _require_root(self):
        if not os.path.isdir(self.root):
            raise RegistryUnavailableError(self.root)

    def _listdir(self):
        try:
            return os.listdir(self.root)
        except OSError as e:
            raise RegistryUnavailableError(self.root, str(e)) from e

    def _fences(self, names):
        out = []
        for name in names:
            m = _FENCE_RE.match(name)
            if m:
                out.append((int(m.group(1)), int(m.group(2))))
        out.sort()
        return out

    @staticmethod
    def _read_json(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

"""Versioned, schema-validated persistent tuning cache (the port's copy of
the JAX package's ``repro.tuning.cache``: the same schema, migrations,
quarantine and lock, at a path of its own — the two packages never write
one file).

One JSON document per cache path, shared by every layer (kernel tuner,
plan compiler), so a config measured anywhere is reusable everywhere —
including across process restarts.

Schema (version 2 — version 1 plus an optional per-entry ``schedule``)::

    {
      "schema": 2,
      "entries": {
        "<TuneKey.encode()>": {
          "config":  {block, n1, n2, n3, karatsuba, precision, col_block,
                      residency, phase_block, buffer_depth},
          "schedule": {segments: [{n1, n2, n3, karatsuba}, ...],
                       block, col_block, precision, residency,
                       phase_block, buffer_depth},   # optional
          "seconds": <measured wall seconds or null>,
          "source":  "search" | "sweep" | "migrated",
          "updated_utc": "YYYY-MM-DDTHH:MM:SSZ"
        }, ...
      }
    }

``config`` is always present — every consumer that only understands flat
configs (``get``) keeps working; ``schedule`` appears when the entry was
produced by the schedule-graph search and carries per-segment decisions
a flat config cannot express. ``get_schedule`` resolves EITHER form: an
entry without a ``schedule`` resolves as its config's degenerate
one-segment schedule, so schema-1 entries serve schedule consumers
without re-search.

Migrations, both transparent on load:

* schema 1 -> 2: entries pass through untouched (schema 1 is a strict
  subset); the file is rewritten in schema 2 on the next ``put``.
* the pre-subsystem flat cache (the JAX package's first autotuner) — a
  ``{"<backend>_B<batch>_n<n>": {config..., seconds}}`` dict with exact
  batch, no device fingerprint, no version: batch normalizes to its
  power-of-two bucket (the fastest entry wins a bucket collision), the
  current process's device fingerprint is stamped (the legacy cache was
  by definition measured here).

The in-process layer keeps the parsed document per path and re-reads only
when the file's mtime changes, so compile-time lookups (one per dispatch)
never re-parse JSON. Writes are atomic (tmp + rename) and lock-guarded.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Optional

try:
    import fcntl
except ImportError:          # non-POSIX: in-process locking only
    fcntl = None

from repro_torch.tuning.space import (
    KIND_KERNEL,
    KernelConfig,
    Schedule,
    TuneKey,
    bucket_batch,
    device_fingerprint,
)

CACHE_SCHEMA = 2
# schema versions a loaded document may carry; anything else is rejected
_KNOWN_SCHEMAS = (1, CACHE_SCHEMA)

_logger = logging.getLogger(__name__)
# cache paths whose corruption has already been logged (log once per
# path per process — a corrupt file would otherwise warn on every load
# until the first put() rewrites it)
_QUARANTINE_WARNED: set = set()


def default_cache_path() -> str:
    """$REPRO_TORCH_AUTOTUNE_CACHE if set, else the user cache directory
    ($XDG_CACHE_HOME or ~/.cache)/repro_torch/autotune_cache.json — never
    inside the repository, and never the JAX package's file."""
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "repro_torch", "autotune_cache.json")


def _utc_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def validate_cache_doc(doc: dict) -> dict:
    """Assert ``doc`` is a well-formed schema-1 or schema-2 cache; raises
    ValueError with the first defect, returns the doc so callers can
    chain. (Schema 1 stays valid: a loaded 1 migrates to 2 in memory —
    see ``migrate_schema1_doc`` — but rejecting it here would break every
    process still holding an un-rewritten file.)"""
    if not isinstance(doc, dict):
        raise ValueError("cache doc must be a JSON object")
    if doc.get("schema") not in _KNOWN_SCHEMAS:
        raise ValueError(
            f"cache schema {doc.get('schema')!r} not in {_KNOWN_SCHEMAS}")
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        raise ValueError("cache entries must be an object")
    for key, entry in entries.items():
        TuneKey.decode(key)                      # raises on malformed keys
        if not isinstance(entry, dict) or "config" not in entry:
            raise ValueError(f"entry {key!r} missing 'config'")
        KernelConfig.from_dict(entry["config"])  # raises on bad knobs
        if entry.get("schedule") is not None:
            Schedule.from_dict(entry["schedule"])   # raises on bad knobs
        sec = entry.get("seconds")
        if sec is not None and not isinstance(sec, (int, float)):
            raise ValueError(f"entry {key!r}: seconds is not a number")
    return doc


def migrate_legacy_doc(doc: dict) -> dict:
    """A legacy flat ``{"backend_B<b>_n<n>": {...}}`` dict -> schema 1.

    Batch buckets to the serving power-of-two grid (fastest entry wins a
    collision); the current device fingerprint is stamped on every entry
    (a legacy cache was measured in-process, i.e. on this device kind:
    the CPU for a "cpu" entry, else the card; an entry of a card this
    process does not have is dropped).
    """
    entries: dict = {}
    for key, cfg in doc.items():
        try:
            backend, b_part, n_part = key.rsplit("_", 2)
            batch = int(b_part.lstrip("B"))
            n = int(n_part.lstrip("n"))
            config = KernelConfig.from_dict(cfg)
            device = device_fingerprint("cpu" if backend == "cpu" else None)
        except Exception:
            continue                              # unparseable: drop
        tk = TuneKey(kind=KIND_KERNEL, backend=backend, device=device,
                     n=n, batch=bucket_batch(batch), lines=16)
        seconds = cfg.get("seconds") if isinstance(cfg, dict) else None
        prev = entries.get(tk.encode())
        if prev is not None and seconds is not None \
                and prev.get("seconds") is not None \
                and prev["seconds"] <= seconds:
            continue                              # bucket collision: keep faster
        entries[tk.encode()] = {
            "config": config.to_dict(), "seconds": seconds,
            "source": "migrated", "updated_utc": _utc_now(),
        }
    return {"schema": CACHE_SCHEMA, "entries": entries}


def migrate_schema1_doc(doc: dict) -> dict:
    """A schema-1 document -> schema 2. Entries pass through untouched —
    schema 1 is a strict subset of 2 (no ``schedule`` field); a flat
    entry resolves through ``get_schedule`` as its degenerate one-segment
    schedule, so no re-search is ever needed."""
    out = dict(doc)
    out["schema"] = CACHE_SCHEMA
    return out


class TuneCache:
    """One cache file + its in-process layer. Thread-safe."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._lock = threading.Lock()
        self._mtime: Optional[float] = None
        self._doc: Optional[dict] = None

    # -- document ------------------------------------------------------------
    def _load_locked(self) -> dict:
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            self._mtime, self._doc = None, {"schema": CACHE_SCHEMA,
                                            "entries": {}}
            return self._doc
        if self._doc is not None and mtime == self._mtime:
            return self._doc
        try:
            with open(self.path) as f:
                raw = json.load(f)
            if "schema" not in raw:               # legacy flat autotune dict
                doc = migrate_legacy_doc(raw)
            else:
                doc = validate_cache_doc(raw)
                if doc.get("schema") == 1:        # schema 1: bump in memory
                    doc = migrate_schema1_doc(doc)
        except (ValueError, OSError, KeyError, TypeError,
                AttributeError) as e:
            # ValueError covers truncated/garbage JSON and schema
            # rejection; the rest cover well-formed JSON of the wrong
            # shape hitting the legacy migrator.
            # Corrupt cache file (truncated write, foreign schema, a
            # fault-injected chaos run): QUARANTINE it — move the bytes
            # aside for post-mortem instead of deleting evidence or
            # failing every warm() forever — and rebuild empty. The
            # tuner simply re-measures; a cache is a cache.
            self._quarantine_locked(e)
            self._mtime, self._doc = None, {"schema": CACHE_SCHEMA,
                                            "entries": {}}
            return self._doc
        self._mtime, self._doc = mtime, doc
        return doc

    def _quarantine_locked(self, err: Exception) -> None:
        corrupt = self.path + ".corrupt"
        try:
            os.replace(self.path, corrupt)
            moved = True
        except OSError:
            moved = False                # read-only dir: warn-only path
        if self.path not in _QUARANTINE_WARNED:   # log once per path
            _QUARANTINE_WARNED.add(self.path)
            _logger.warning(
                "tuning cache %s is unreadable (%s: %s); %s — rebuilding "
                "an empty cache", self.path, type(err).__name__, err,
                f"quarantined to {corrupt}" if moved
                else "could not quarantine (filesystem error)")

    def doc(self) -> dict:
        """The parsed (and, if needed, migrated) schema-2 document."""
        with self._lock:
            return self._load_locked()

    def _save_locked(self, doc: dict) -> None:
        validate_cache_doc(doc)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        os.replace(tmp, self.path)
        try:
            self._mtime = os.path.getmtime(self.path)
        except OSError:
            self._mtime = None
        self._doc = doc

    # -- entries -------------------------------------------------------------
    def get_entry(self, key: TuneKey) -> Optional[dict]:
        with self._lock:
            return self._load_locked()["entries"].get(key.encode())

    def get(self, key: TuneKey) -> Optional[KernelConfig]:
        entry = self.get_entry(key)
        if entry is None:
            return None
        return KernelConfig.from_dict(entry["config"])

    def get_schedule(self, key: TuneKey) -> Optional[Schedule]:
        """The entry's Schedule: the stored one when the graph search
        persisted it, else the flat config's degenerate one-segment
        schedule — so schema-1(-migrated) entries serve schedule
        consumers WITHOUT re-search."""
        entry = self.get_entry(key)
        if entry is None:
            return None
        if entry.get("schedule") is not None:
            return Schedule.from_dict(entry["schedule"])
        return Schedule.from_config(KernelConfig.from_dict(entry["config"]))

    @contextlib.contextmanager
    def _file_lock(self):
        """Advisory cross-process lock around read-modify-write: two
        serving processes warming different keys against the shared cache
        must not overwrite each other's just-persisted sweeps."""
        if fcntl is None:
            yield
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path + ".lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    def _put_entry(self, key: TuneKey, entry: dict) -> None:
        """Insert/replace one entry and persist atomically (also rewrites
        a legacy- or schema-1-format file in schema 2). The merge is done
        under a cross-process file lock against a freshly re-read
        document, so concurrent writers keep each other's entries."""
        with self._lock, self._file_lock():
            self._mtime = None           # force a re-read under the lock
            self._doc = None
            doc = dict(self._load_locked())
            doc["entries"] = dict(doc["entries"])
            doc["entries"][key.encode()] = entry
            self._save_locked(doc)

    def put(self, key: TuneKey, config: KernelConfig,
            seconds: Optional[float] = None, source: str = "search") -> None:
        """Insert/replace the flat-config entry for ``key``."""
        self._put_entry(key, {
            "config": config.to_dict(),
            "seconds": None if seconds is None else float(seconds),
            "source": source, "updated_utc": _utc_now(),
        })

    def put_schedule(self, key: TuneKey, schedule: Schedule,
                     seconds: Optional[float] = None,
                     source: str = "search") -> None:
        """Insert/replace a Schedule entry for ``key``. The flat-config
        view is derived and stored alongside, so flat-only consumers
        (``get``) keep resolving the entry."""
        self._put_entry(key, {
            "config": schedule.to_config().to_dict(),
            "schedule": schedule.to_dict(),
            "seconds": None if seconds is None else float(seconds),
            "source": source, "updated_utc": _utc_now(),
        })


# per-path singletons so every layer shares one in-process view
_CACHES: dict = {}
_CACHES_LOCK = threading.Lock()


def get_cache(path: Optional[str] = None) -> TuneCache:
    p = path or default_cache_path()
    with _CACHES_LOCK:
        if p not in _CACHES:
            _CACHES[p] = TuneCache(p)
        return _CACHES[p]


def clear_memory_cache() -> None:
    """Drop every in-process cache view (tests; the files are untouched)."""
    with _CACHES_LOCK:
        _CACHES.clear()

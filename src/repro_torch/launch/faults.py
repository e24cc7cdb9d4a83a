"""Deterministic, seed-driven fault injection for the serving stack.

Counterpart of ``repro.launch.faults``.  The engine's program cache
(``GoldDiffEngine.program``) is the one dispatch seam every trajectory
segment goes through; this module installs a hook there
(``repro_torch.kernels.ops.set_dispatch_hook``) that draws one decision
per lookup and per dispatch from a counter-based splitmix64 stream:

* the same ``FaultConfig.seed`` and the same dispatch order give the
  same faults at the same points, whatever the clock, retries or load
  (a retry is a new dispatch with its own decision);
* with no injector installed ``engine.program`` returns its own cached
  callables unchanged.

Fault kinds (independent per-dispatch probabilities):

* ``nan``        -- one output row set to NaN, on a clone of the output
  tensor, after the program ran (exercises the runtime's per-row finite
  guard and the indexed->exact rung);
* ``latency``    -- a sleep of ``latency_s`` before the dispatch;
* ``error``      -- raises :class:`InjectedInternalError`
  ("INTERNAL: ..."), a transient executor failure (retries);
* ``oom``        -- raises :class:`InjectedOOMError`
  ("RESOURCE_EXHAUSTED: ...", the halve-batch / fewer-steps rung);
* ``shard_drop`` -- raises an ``InjectedInternalError`` for a lost
  shard; fires only on a dispatch whose program key carries a mesh
  signature of more than one shard (``GoldDiffEngine.mesh_sig``), the
  reference's "more than one device in the mesh";
* ``evict``      -- deletes the cache entry before the hit/miss check,
  so the lookup really builds again (on the card: captures again), a
  build storm for the plan->scan rung.

``RETRYABLE_ERRORS`` is what the runtime retries: the injected classes,
:class:`TransientExecutorError` and ``torch.cuda.OutOfMemoryError``, the
one CUDA error that leaves the context usable.  Any other error, such as
an illegal address or a launch failure (sticky: the context is
poisoned), is not retried and propagates out of ``ServeRuntime.pump``.

Only program kinds in ``target_kinds`` are touched (default: the
compute segments); the runtime's Gaussian fallback is not among them.

An injector draws each outcome before applying it (``draw_lookup``,
``draw_dispatch``; ``evict_entry`` and ``dispatch`` apply one), so that
over a ``ProcessMesh`` the serving runtime can make every rank take the
same outcome (:class:`Agreement`), whichever ranks have an injector.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace


class InjectedRuntimeError(RuntimeError):
    """Base of the injected executor failures.  ``agreed`` is True where
    every rank of a ``ProcessMesh`` raised it at the same dispatch
    (:class:`Agreement`): over ranks the serving runtime retries only
    such an error."""

    agreed = False


class InjectedInternalError(InjectedRuntimeError):
    """Injected transient executor failure ("INTERNAL: ...")."""


class InjectedOOMError(InjectedRuntimeError):
    """Injected allocation failure ("RESOURCE_EXHAUSTED: ...")."""


class TransientExecutorError(RuntimeError):
    """A transient failure of another flavour, equally retryable."""


# what the serving runtime treats as transient and retries
RETRYABLE_ERRORS = (InjectedRuntimeError, TransientExecutorError,
                    torch.cuda.OutOfMemoryError)

# program kinds the injector touches by default: the trajectory compute
# segments (plan buckets, plain and mixed-cursor, and the scan-mode
# program) and the reference's static kinds, kept for parity.  The
# runtime's Gaussian fallback ("gauss_seg") is not among them: a
# fallback that can itself be faulted is not a fallback.
DEFAULT_TARGETS = ("plan_seg", "plan_seg_mix", "serve_scan", "denoise",
                   "fused_step", "full_scan")

def sharded(key) -> bool:
    """Whether a program key carries a mesh signature of more than one
    shard: ``("mesh", shard_axis, shards, batch_axis, batch_shards)``."""
    return any(isinstance(e, tuple) and len(e) == 5 and e[0] == "mesh"
               and e[2] > 1 for e in key)


FAULT_KINDS = ("nan", "latency", "error", "oom", "shard_drop", "evict")

_M64 = (1 << 64) - 1
_SALT = {"nan": 0x1, "latency": 0x2, "error": 0x3, "oom": 0x4,
         "shard_drop": 0x5, "evict": 0x6, "row": 0x65}


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def unit_uniform(seed: int, n: int, salt: int = 0) -> float:
    """Deterministic uniform in [0, 1) from (seed, counter, salt).

    Pure integer hashing — no global RNG state, so interleaved
    consumers (the injector's per-kind decisions, the runtime's backoff
    jitter) never perturb each other's streams.
    """
    z = (seed * 0xD1B54A32D192ED03 + n * 0x8CB92BA72F3D8DD7
         + salt * 0x2545F4914F6CDD1D) & _M64
    return _splitmix64(z) / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-dispatch fault probabilities (all default off)."""

    seed: int = 0
    nan_rate: float = 0.0
    latency_rate: float = 0.0
    latency_s: float = 0.01
    error_rate: float = 0.0
    oom_rate: float = 0.0
    shard_drop_rate: float = 0.0
    evict_rate: float = 0.0
    target_kinds: tuple = DEFAULT_TARGETS


class FaultInjector:
    """The hook object ``engine.program`` consults (see module doc).

    ``events`` records every fired fault as ``(kind, program_kind,
    counter)`` tuples — the determinism and seam-reach tests assert on
    this log.  ``dispatches`` counts wrapped executions, ``lookups``
    counts cache lookups (the evict stream), both monotone.
    """

    def __init__(self, config: FaultConfig):
        self.config = config
        self.dispatches = 0
        self.lookups = 0
        self.events: list[tuple] = []

    # -- decision stream -----------------------------------------------------
    def _targets(self, key) -> bool:
        return (isinstance(key, tuple) and len(key) > 0
                and key[0] in self.config.target_kinds)

    def _hit(self, n: int, kind: str, rate: float) -> bool:
        return rate > 0.0 and \
            unit_uniform(self.config.seed, n, _SALT[kind]) < rate

    def draw_lookup(self, key) -> tuple[int, bool] | None:
        """The next lookup decision for ``key``: ``(counter, evict)``, or
        None for a kind the injector does not touch (no counter used)."""
        if not self._targets(key):
            return None
        n = self.lookups
        self.lookups += 1
        return n, self._hit(n, "evict", self.config.evict_rate)

    def draw_dispatch(self, key) -> Draw | None:
        """The next dispatch's outcome for ``key`` (None: untouched
        kind), drawn before anything runs: the latency sleep, the
        exception to raise (shard_drop first, then oom, then error) and
        the NaN row's uniform."""
        if not self._targets(key):
            return None
        n = self.dispatches
        self.dispatches += 1
        cfg = self.config
        raise_kind = None
        if cfg.shard_drop_rate > 0.0 and sharded(key) \
                and self._hit(n, "shard_drop", cfg.shard_drop_rate):
            raise_kind = "shard_drop"
        elif self._hit(n, "oom", cfg.oom_rate):
            raise_kind = "oom"
        elif self._hit(n, "error", cfg.error_rate):
            raise_kind = "error"
        return Draw(n=n,
                    latency_s=(cfg.latency_s if self._hit(
                        n, "latency", cfg.latency_rate) else None),
                    raise_kind=raise_kind,
                    nan_u=(unit_uniform(cfg.seed, n, _SALT["row"])
                           if self._hit(n, "nan", cfg.nan_rate) else None))

    # -- hook protocol (called by GoldDiffEngine.program) --------------------
    def on_program(self, engine, key) -> None:
        """Cache-lookup hook: may evict the entry (a build storm)."""
        d = self.draw_lookup(key)
        if d is not None:
            evict_entry(engine, key, d[0], d[1], self)

    def wrap(self, key, fn):
        """Dispatch hook: returns ``fn`` or a fault-wrapped callable."""
        if not self._targets(key):
            return fn

        def wrapped(*args, **kw):
            return dispatch(key, fn, args, kw, self.draw_dispatch(key), self)

        return wrapped


@dataclasses.dataclass(frozen=True)
class Draw:
    """One dispatch's drawn outcome (:meth:`FaultInjector.draw_dispatch`):
    its counter, the latency sleep (None: none), the exception kind to raise
    (None, "shard_drop", "oom" or "error") and, for a NaN corruption, the
    uniform that picks its row (None: none)."""

    n: int
    latency_s: float | None = None
    raise_kind: str | None = None
    nan_u: float | None = None


_RAISES = (None, "error", "oom", "shard_drop")   # agreement codes 0..3


def _record(injector, kind: str, key, n: int) -> None:
    """Log a fired fault to the injector's tuple list (where this rank
    has one) and to the current tracer (``fault.<kind>`` point events on
    the unified schema, no-ops when tracing is off), so injections
    appear inline with the dispatch/segment spans they hit."""
    if injector is not None:
        injector.events.append((kind, key[0], n))
    tr = obs_trace.tracer()
    if tr.enabled:
        tr.event(f"fault.{kind}", program=key[0], counter=n)


def evict_entry(engine, key, n: int, evict: bool, injector=None) -> None:
    """Apply a lookup decision: delete the cached entry, so the lookup
    really builds again."""
    if evict and key in engine._programs:
        del engine._programs[key]
        _record(injector, "evict", key, n)


def dispatch(key, fn, args, kw, draw: Draw | None, injector=None):
    """Run ``fn(*args, **kw)`` under a dispatch outcome: the latency
    sleep, the injected exception, or the program and then its NaN
    row."""
    if draw is None:
        return fn(*args, **kw)
    n = draw.n
    if draw.latency_s is not None:
        _record(injector, "latency", key, n)
        time.sleep(draw.latency_s)
    if draw.raise_kind == "shard_drop":
        _record(injector, "shard_drop", key, n)
        raise InjectedInternalError(
            "INTERNAL: injected shard dropout: mesh device "
            "unavailable during collective")
    if draw.raise_kind == "oom":
        _record(injector, "oom", key, n)
        raise InjectedOOMError(
            "RESOURCE_EXHAUSTED: injected out-of-memory "
            "allocating temporary buffer")
    if draw.raise_kind == "error":
        _record(injector, "error", key, n)
        raise InjectedInternalError(
            "INTERNAL: injected transient executor failure")
    out = fn(*args, **kw)
    if draw.nan_u is not None:
        out = corrupt(out, draw.nan_u, key, n, injector)
    return out


def corrupt(out, u: float, key, n: int, injector=None):
    """NaN one row of a float batch output (row ``int(u * rows) %
    rows``), on a clone of it (the cached program's own output buffer
    stays as it was)."""
    if not isinstance(out, torch.Tensor) or out.ndim == 0 \
            or not out.is_floating_point() or out.shape[0] == 0:
        return out
    a = out.clone()
    row = int(u * a.shape[0]) % a.shape[0]
    a[row] = float("nan")
    _record(injector, "nan", key, n)
    return a


def _bits(x: float | None) -> int:
    """A non-negative float's IEEE bits as an int64 (None: 0), which
    orders as the floats do, so a maximum over ranks keeps it whole."""
    return 0 if x is None else int(np.float64(x).view(np.int64))


def _unbits(b: int) -> float:
    return float(np.int64(b).view(np.float64))


class Agreement:
    """Rank-agreed fault outcomes at the dispatch seam over a
    ``ProcessMesh``: each rank draws from its own injector, if it has
    one (ranks without one draw nothing), and ``host_max`` over the mesh's
    host channel makes the outcome every rank's, before anything runs:

    * a lookup's eviction, so that every rank rebuilds (on NCCL:
      captures again, collectives and all) or none does;
    * a dispatch's latency, its exception (by a maximum of the codes
      none < error < oom < shard_drop, so every rank raises the same
      class) and its NaN row, whose ``fault.<kind>`` trace event every
      rank records.

    So an injector installed on one rank gives every rank the faults an
    injector of the same config on every rank gives.  The serving runtime
    turns it on (``active``) for a scheduler step when some rank has an
    injector installed; then every program lookup and dispatch of the
    step agrees (one ``host_max`` each), whatever its kind, since a rank
    without an injector cannot tell which kinds another rank's targets.
    Off, the seam adds no collective.  An exception it raised so is
    marked ``agreed``.  Any other error, such as one raised inside a
    running program on one rank, is not agreed and is never retried over
    ranks: it propagates out of ``pump()`` on its rank, and the other
    ranks' next collective fails within the groups' timeout, so their
    ``pump()`` raises too."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.active = False

    def on_program(self, engine, key, hook) -> None:
        d = hook.draw_lookup(key) if hook is not None else None
        n1, evict = self.mesh.host_max(
            [0, 0] if d is None else [d[0] + 1, int(d[1])])
        if n1:
            evict_entry(engine, key, n1 - 1, bool(evict), hook)

    def wrap(self, key, fn, hook):
        def agreed(*args, **kw):
            d = hook.draw_dispatch(key) if hook is not None else None
            v = [0] * 6 if d is None else [
                d.n + 1, _RAISES.index(d.raise_kind),
                int(d.latency_s is not None), _bits(d.latency_s),
                int(d.nan_u is not None), _bits(d.nan_u)]
            n1, code, lat, lat_s, nan, u = self.mesh.host_max(v)
            draw = None if not n1 else Draw(
                n=n1 - 1, latency_s=_unbits(lat_s) if lat else None,
                raise_kind=_RAISES[code], nan_u=_unbits(u) if nan else None)
            if draw is None or draw.raise_kind is None:
                return dispatch(key, fn, args, kw, draw, hook)
            try:                         # raises before ``fn`` runs
                dispatch(key, fn, args, kw, draw, hook)
            except InjectedRuntimeError as e:
                e.agreed = True
                raise

        return agreed


def install(config: FaultConfig) -> FaultInjector:
    """Build an injector for ``config`` and install it as THE hook."""
    injector = FaultInjector(config)
    ops.set_dispatch_hook(injector)
    return injector


def uninstall() -> None:
    """Clear the hook: the dispatch seam is an identity again."""
    ops.set_dispatch_hook(None)


def active() -> FaultInjector | None:
    """The currently installed injector (``None`` when faults are off)."""
    return ops.dispatch_hook()


@contextlib.contextmanager
def injected(config: FaultConfig):
    """``with injected(FaultConfig(...)) as inj:`` — scoped install."""
    injector = install(config)
    try:
        yield injector
    finally:
        uninstall()


# -- on-disk store corruption (crash / bit-rot simulation) --------------------
#
# The dispatch-hook faults above attack the *compute* path; these attack
# the *persistence* path: each injector deterministically damages one
# on-disk golden-store artifact the way a real failure would, so the
# chaos suite can assert that every regime surfaces as a typed load
# error (StoreCorruptionError / StoreVersionError) or a quarantined
# epoch — never as silent garbage served to a request.

STORE_CORRUPTIONS = ("truncate", "bitflip", "stale_manifest", "torn_rename")


def corrupt_store(npz_path: str, kind: str, seed: int = 0) -> str:
    """Deterministically damage one persisted artifact.

    ``npz_path`` is the arrays file (its manifest sidecar is
    ``<npz_path>.manifest.json``); ``kind``:

    * ``truncate``       — cut the npz to 60% of its bytes (a crash
      mid-write / partial copy);
    * ``bitflip``        — flip one bit at a seed-chosen offset (media
      rot; the per-array sha256 must catch it);
    * ``stale_manifest`` — bump the manifest's format version (an
      artifact from an incompatible future writer);
    * ``torn_rename``    — overwrite npz bytes while leaving the
      manifest untouched (the rename landed but the content belongs to
      a different write — checksum mismatch).

    Returns a short description of what was done (for test output).
    """
    import json
    import os

    manifest = npz_path + ".manifest.json"
    if kind == "truncate":
        size = os.path.getsize(npz_path)
        keep = max(1, (size * 6) // 10)
        with open(npz_path, "rb+") as f:
            f.truncate(keep)
        return f"truncated {npz_path} from {size} to {keep} bytes"
    if kind == "bitflip":
        with open(npz_path, "rb+") as f:
            data = bytearray(f.read())
            ofs = int(unit_uniform(seed, 0, 0x51) * len(data)) % len(data)
            data[ofs] ^= 1 << (int(unit_uniform(seed, 1, 0x52) * 8) % 8)
            f.seek(0)
            f.write(data)
        return f"flipped one bit at offset {ofs} of {npz_path}"
    if kind == "stale_manifest":
        with open(manifest) as f:
            m = json.load(f)
        m["format_version"] = int(m.get("format_version", 1)) + 1
        with open(manifest, "w") as f:
            json.dump(m, f)
        return f"bumped {manifest} to version {m['format_version']}"
    if kind == "torn_rename":
        # a structurally valid npz whose content belongs to a DIFFERENT
        # write (same schema, different bytes) lands under the old
        # manifest: only the per-array sha256 can catch it
        with np.load(npz_path) as z:
            shapes = {k: (z[k].shape, z[k].dtype) for k in z.files}
        np.savez(npz_path, **{k: np.full(s, 0.5, dt) if
                              np.issubdtype(dt, np.floating)
                              else np.ones(s, dt) + 1
                              for k, (s, dt) in shapes.items()})
        return f"replaced {npz_path} content under its old manifest"
    raise ValueError(f"unknown store corruption {kind!r} "
                     f"(have {STORE_CORRUPTIONS})")

"""Fault injection (``repro_torch.launch.faults``) held against the
reference's (``repro.launch.faults``): the splitmix64 stream, the
injector's decisions and log for the same lookups and dispatches, the
store corruptions byte for byte, the retryable classes, and the
dispatch seam's identity with no hook."""
import os

import numpy as np
import pytest
import torch

import repro.launch.faults as r_faults
from repro_torch.core import GoldDiffEngine, make_schedule
from repro_torch.data.synthetic import gmm
from repro_torch.kernels import ops
from repro_torch.launch import faults
from repro_torch.launch.faults import (DEFAULT_TARGETS, FAULT_KINDS,
                                       RETRYABLE_ERRORS, FaultConfig,
                                       FaultInjector, InjectedInternalError,
                                       InjectedOOMError,
                                       TransientExecutorError, unit_uniform)


def test_constants_match_reference():
    assert DEFAULT_TARGETS == r_faults.DEFAULT_TARGETS
    assert FAULT_KINDS == r_faults.FAULT_KINDS
    assert faults.STORE_CORRUPTIONS == r_faults.STORE_CORRUPTIONS
    assert faults._SALT == r_faults._SALT


@pytest.mark.parametrize("seed", [0, 1, 123, 2 ** 40 + 7])
def test_unit_uniform_bit_equal(seed):
    for n in range(200):
        for salt in (0, 0x1, 0x65, 0xB0):
            assert unit_uniform(seed, n, salt) == \
                r_faults.unit_uniform(seed, n, salt)


class FakeEngine:
    def __init__(self, keys):
        self._programs = {k: (lambda x: x) for k in keys}


@pytest.mark.parametrize("rates", [
    dict(nan_rate=0.3), dict(error_rate=0.4), dict(oom_rate=0.5),
    dict(evict_rate=0.5), dict(latency_rate=0.2, latency_s=0.0),
    dict(nan_rate=0.2, error_rate=0.2, oom_rate=0.2, evict_rate=0.2),
])
def test_injector_decisions_match_reference(rates):
    """The same lookups and dispatches fire the same faults at the same
    counters, NaN the same row, and raise the reference's messages."""
    keys = [("plan_seg", 0), ("plan_seg_mix", 1), ("gauss_seg", 2),
            ("serve_scan", 3)]
    out = []
    for mod, arr in ((faults, lambda: torch.ones(5, 3)),
                     (r_faults, lambda: np.ones((5, 3), np.float32))):
        inj = mod.FaultInjector(mod.FaultConfig(seed=11, **rates))
        eng = FakeEngine(keys)
        log = []
        for i in range(60):
            key = keys[i % len(keys)]
            inj.on_program(eng, key)
            fn = inj.wrap(key, eng._programs.get(key, lambda x: x))
            try:
                y = np.asarray(fn(arr()))
                log.append(("ok", tuple(np.isnan(y).any(1))))
            except RuntimeError as e:
                log.append(("raise", str(e)))
            eng._programs.setdefault(key, lambda x: x)
        out.append((log, list(inj.events),
                    inj.dispatches, inj.lookups))
    assert out[0] == out[1]


def test_corrupt_clones_and_raised_classes():
    inj = FaultInjector(FaultConfig(seed=0, nan_rate=1.0))
    x = torch.ones(4, 2)
    y = inj.wrap(("plan_seg",), lambda v: v)(x)
    assert torch.isnan(y).any() and not torch.isnan(x).any()
    for rate, cls, msg in (("error_rate", InjectedInternalError, "INTERNAL"),
                           ("oom_rate", InjectedOOMError,
                            "RESOURCE_EXHAUSTED")):
        inj = FaultInjector(FaultConfig(**{rate: 1.0}))
        with pytest.raises(cls, match=msg):
            inj.wrap(("plan_seg",), lambda v: v)(x)


def test_retryable_classes():
    assert issubclass(InjectedInternalError, RETRYABLE_ERRORS)
    assert issubclass(InjectedOOMError, RETRYABLE_ERRORS)
    assert issubclass(TransientExecutorError, RETRYABLE_ERRORS)
    assert issubclass(torch.cuda.OutOfMemoryError, RETRYABLE_ERRORS)
    for cls in (RuntimeError, ValueError, torch.AcceleratorError
                if hasattr(torch, "AcceleratorError") else KeyError):
        assert not issubclass(cls, RETRYABLE_ERRORS)


def test_shard_drop_inert_on_one_device():
    """shard_drop keys on the program key's mesh signature: inert on an
    unsharded key (and on a mesh of one shard), fires on a sharded one."""
    inj = FaultInjector(FaultConfig(shard_drop_rate=1.0))
    assert inj.wrap(("plan_seg",), lambda v: v)(3) == 3
    one = ("plan_seg", ("mesh", "data", 1, None, 1))
    assert inj.wrap(one, lambda v: v)(3) == 3
    assert inj.events == []
    two = ("plan_seg", ("mesh", "data", 2, None, 1))
    with pytest.raises(InjectedInternalError, match="shard dropout"):
        inj.wrap(two, lambda v: v)(3)
    assert [e[0] for e in inj.events] == ["shard_drop"]


def test_dispatch_seam_identity_and_scoped_install():
    eng = GoldDiffEngine(gmm(64, device="cpu"), make_schedule("ddpm_linear"),
                         device="cpu")
    fn = eng.program(("plan_seg", "x"), lambda: (lambda v: v + 1))
    assert ops.dispatch_hook() is None and faults.active() is None
    assert eng.program(("plan_seg", "x"), None) is fn
    with faults.injected(FaultConfig(evict_rate=1.0)) as inj:
        assert faults.active() is inj
        b0 = eng._builds
        wrapped = eng.program(("plan_seg", "x"), lambda: (lambda v: v + 2))
        assert eng._builds == b0 + 1 and wrapped is not fn
        assert wrapped(1) == 3
        assert [e[0] for e in inj.events] == ["evict"]
    assert ops.dispatch_hook() is None


@pytest.mark.parametrize("kind", r_faults.STORE_CORRUPTIONS)
def test_store_corruptions_byte_equal(tmp_path, kind):
    """Each kind does to a file what the reference's does, byte for
    byte (torn_rename writes an npz of its own, compared by content)."""
    paths = []
    for sub, mod in (("ref", r_faults), ("port", faults)):
        d = tmp_path / sub
        d.mkdir()
        npz = str(d / "a.npz")
        np.savez(npz, x=np.arange(64, dtype=np.float32).reshape(8, 8),
                 i=np.arange(5, dtype=np.int32))
        with open(npz + ".manifest.json", "w") as f:
            f.write('{"format_version": 1}')
        mod.corrupt_store(npz, kind, seed=3)
        paths.append(npz)
    a, b = (open(p, "rb").read() for p in paths)
    if kind == "torn_rename":
        za, zb = np.load(paths[0]), np.load(paths[1])
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])
    else:
        assert a == b
    ma, mb = (open(p + ".manifest.json").read() for p in paths)
    assert ma == mb
    with pytest.raises(ValueError, match="unknown store corruption"):
        faults.corrupt_store(paths[1], "melt")
    assert os.path.exists(paths[1])

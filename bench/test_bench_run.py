"""A whole run of a cell at a tiny size on the CPU (the harness's look for
a card skipped): the result's keys, the import check, and ``correct``
coming out false under the control and under each fault the served
path can have."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from bench import harness, manifest as mf

REPO = mf.REPO


def tiny(images=4):
    cfg = mf.config("cifar10")
    cfg.update(n=512, image_shape=[8, 8, 3])
    mix = dict(mf.traffic("b16"), images_per_request=[images],
               max_batch=images, check_images=max(8, images))
    return cfg, mix


def run(trace=False, seconds=0.3, images=4, **kw):
    cfg, mix = tiny(images)
    return harness.run("cifar10.b16", 2 ** 31 + 11, seconds, trace,
                       time.perf_counter(), device="cpu", cfg=cfg, mix=mix,
                       log=open(os.devnull, "w"), **kw)


def test_result_keys():
    # a p95 needs two requests or more: a window long enough for them on a
    # loaded host
    r = run(seconds=1.5)
    assert r["attempted"] >= 2
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "compared"]
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in
                                 mf.metrics_for("cifar10.b16", False)}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert list(r["compared"]) == ["gap_median", "off_share", "failed"]
    assert all(c["value"] <= c["limit"] for c in r["compared"].values())
    json.dumps(r)


def test_traced_result_keys():
    r = run(trace=True, seconds=1.5)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "breakdown", "compared"]
    assert r["correct"] is True
    # the CPU has no device events: the spans and counters are read, the
    # device's metrics are left out
    assert set(r["metrics"]) == {"serve_host_ms", "segment_ms",
                                 "captures_after_warmup", "wave_mfu",
                                 "tail_p95_ms"}
    assert r["metrics"]["captures_after_warmup"]["value"] == 0
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_control_is_not_correct():
    r = run(rows_dtype=torch.bfloat16)
    assert r["correct"] is False
    c = r["compared"]
    assert c["gap_median"]["value"] > c["gap_median"]["limit"]
    assert c["off_share"]["value"] > c["off_share"]["limit"]


def _step_unchanged(eng, monkeypatch):
    from repro_torch.core import sampler
    monkeypatch.setattr(sampler, "_masked_step",
                        lambda dm, sch, x, t, tp, caps, clip: x)


def _half_batch(eng, monkeypatch):
    inner = eng._sample_bucket

    def half(x_init):
        out = inner(x_init)
        h = out.shape[0] // 2
        out[h:2 * h] = out[:h]
        return out
    monkeypatch.setattr(eng, "_sample_bucket", half)


def _answer_altered(eng, monkeypatch):
    inner = eng._sample_bucket

    def altered(x_init):
        out = inner(x_init)
        out[:, 0, 0, 0] += 0.01          # one pixel of every image
        return out
    monkeypatch.setattr(eng, "_sample_bucket", altered)


def _one_slot_altered(eng, monkeypatch):
    inner = eng._sample_bucket

    def altered(x_init):
        out = inner(x_init)
        out[0, 0, 0, 0] += 0.01          # one pixel of the wave's first image
        return out
    monkeypatch.setattr(eng, "_sample_bucket", altered)


def broken(fault, monkeypatch):
    """Patch the harness so that the program it builds has ``fault``."""
    build = harness.build_program

    def build_broken(*a, **kw):
        eng = build(*a, **kw)
        fault(eng, monkeypatch)
        return eng
    monkeypatch.setattr(harness, "build_program", build_broken)


@pytest.mark.parametrize("fault,images", [
    (_step_unchanged, 4), (_half_batch, 4), (_answer_altered, 4),
    (_one_slot_altered, 16)],
    ids=["step_unchanged", "half_batch", "answer_altered",
         "one_slot_of_16"])
def test_fault_is_not_correct(fault, images, monkeypatch):
    broken(fault, monkeypatch)
    r = run(images=images)
    assert r["correct"] is False


def test_one_slot_of_16_fails_off_share_alone(monkeypatch):
    # one wrong image in a wave of 16 moves neither the median image's
    # gap nor the failed count: the share of images off has to see it
    broken(_one_slot_altered, monkeypatch)
    c = run(images=16)["compared"]
    assert c["gap_median"]["value"] <= c["gap_median"]["limit"]
    assert c["failed"]["value"] == 0
    assert c["off_share"]["value"] == pytest.approx(1 / 16)
    assert c["off_share"]["value"] > c["off_share"]["limit"]


def test_forbidden_modules_by_whole_name():
    assert harness.forbidden_modules(
        ["repro_torch.core", "jaxlib.xla", "repro.core", "jax", "numpy",
         "flaxx"]) == ["jax", "jaxlib", "repro"]
    assert harness.forbidden_modules(["repro_torch", "reproduce"]) == []


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "from bench import harness, control, run\n"
            "import repro_torch.launch.serve, repro_torch.core\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cli_refuses_without_enough_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "cifar10.b16", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "cifar10.b16", "--seed", "12345", "--seconds",
                          "2", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]

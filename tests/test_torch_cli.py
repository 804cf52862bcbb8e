"""The port's CLI checkpoint/resume and --profile on the CPU
(pyrite_tpu_torch/cli.py).

A checkpoint is an .npz with the JAX CLI's keys (acc, wt, samples_done) and
the port's lane_samples, each render lane's count of exposed samples. The
draws are keyed by (pixel, sample, bounce, purpose) and a resumed render
starts every lane at its next sample, so a render checkpointed after its
first round and resumed equals the straight render (wt bit-equal, acc
within rtol 1e-5); so does one resumed from a file with the JAX keys alone,
which resumes by the JAX rule (samples_done for every pixel)."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from pyrite_tpu import cli as jax_cli
from pyrite_tpu_torch import cli
from pyrite_tpu_torch.renderers import simple

torch.set_num_threads(2)


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("cli"))
    return chip_smoke.scene_paths(directory, width=32, height=16, spectrum_samples=4,
                                  bounces=8)["flagship"]


def _cli(monkeypatch, path, *args, stop_after=None):
    """cli.main on the CPU; returns (acc, wt) of its render and the number
    of progress callbacks it saw. ``stop_after`` n: raise after the n-th
    callback (the CLI has written its checkpoint by then)."""
    render = simple.render
    seen = {"calls": 0}

    def recording(*a, on_progress=None, **k):
        def progress(p):
            on_progress(p)
            seen["calls"] += 1
            if seen["calls"] == stop_after:
                raise _Stop

        film, acc, wt = render(*a, on_progress=progress, **k)
        seen["film"] = (acc.clone(), wt.clone())
        return film, acc, wt

    monkeypatch.setattr(simple, "render", recording)
    out = os.path.join(os.path.dirname(path), "out.png")
    assert cli.main([path, "--device", "cpu", "--output", out, "--preview-interval", "0", *args]) == 0
    return seen["film"], seen["calls"]


def _same(got, want):
    assert torch.equal(got[1], want[1]) and float(want[1].sum()) > 0
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)


def test_checkpoint_writes_the_jax_keys(flagship, tmp_path, monkeypatch):
    """The file holds the JAX CLI's keys and the lane counts; the JAX CLI
    reads it (all samples done, it renders nothing more)."""
    ck = str(tmp_path / "ck.npz")
    (acc, wt), _ = _cli(monkeypatch, flagship, "--samples", "3", "--checkpoint", ck)
    with np.load(ck) as f:
        assert set(f.files) == {"acc", "wt", "samples_done", "lane_samples"}
        assert int(f["samples_done"]) == 3 and f["acc"].shape == (16, 32, acc.shape[2])
        np.testing.assert_array_equal(f["wt"], wt.numpy())
        assert f["lane_samples"].sum(axis=0).min() == 3
    assert jax_cli.main([flagship, "--samples", "3", "--checkpoint", ck,
                         "--output", str(tmp_path / "jax.png")]) == 0


@pytest.mark.parametrize("scheduler", ["regen", "one-shot"])
def test_resumed_render_equals_straight(flagship, tmp_path, monkeypatch, scheduler):
    """Checkpointed after its first round (regen: a soft-tail launch, so
    lanes hold different counts; one-shot: the first 4-sample step), then
    resumed: the straight render's film."""
    monkeypatch.setattr(simple, "regen_enabled", lambda: scheduler == "regen")
    straight, rounds = _cli(monkeypatch, flagship, "--samples", "9")
    assert rounds > 1
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(_Stop):
        _cli(monkeypatch, flagship, "--samples", "9", "--checkpoint", ck, stop_after=1)
    with np.load(ck) as f:
        first = f["lane_samples"]
    assert 0 < first.sum() < 9 * 32 * 16
    resumed, _ = _cli(monkeypatch, flagship, "--samples", "9", "--checkpoint", ck)
    _same(resumed, straight)


def test_jax_format_checkpoint_resumes(flagship, tmp_path, monkeypatch):
    """A file with acc, wt and samples_done alone (a JAX CLI checkpoint)
    resumes every pixel at samples_done, through regeneration's planes."""
    monkeypatch.setattr(simple, "regen_enabled", lambda: False)
    (acc, wt), _ = _cli(monkeypatch, flagship, "--samples", "2")
    ck = str(tmp_path / "jax.npz")
    np.savez(ck, acc=acc.numpy(), wt=wt.numpy(), samples_done=2)
    monkeypatch.setattr(simple, "regen_enabled", lambda: True)
    straight, _ = _cli(monkeypatch, flagship, "--samples", "7")
    resumed, _ = _cli(monkeypatch, flagship, "--samples", "7", "--checkpoint", ck)
    _same(resumed, straight)


def test_profile_writes_a_trace(flagship, tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    _cli(monkeypatch, flagship, "--samples", "1", "--profile", str(trace_dir))
    traces = list(trace_dir.glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 1000
    assert '"traceEvents"' in traces[0].read_text()


def test_multi_device_is_not_ported(flagship, monkeypatch):
    """Across several CUDA devices the CLI spawns one rank per device over
    NCCL (parallel.spawn with cli.render_rank and the CLI's arguments) and
    builds no scene itself; without CUDA it raises the "no CUDA device"
    error, whatever torch.cuda counts. (The name is the test's from before
    the multi-GPU film merge, when the CLI refused the flag.)"""
    from pyrite_tpu_torch import parallel

    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(parallel, "spawn", lambda *a, **k: calls.append((a, k)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([flagship, "--multi-device", "--samples", "1"])
    assert calls == []

    def no_scene(*a, **k):
        raise AssertionError("the parent built a scene")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cli, "build_scene", no_scene)
    argv = [flagship, "--multi-device", "--samples", "1"]
    assert cli.main(argv) == 0
    assert calls == [((cli.render_rank, ["cuda:0", "cuda:1"], "nccl"), {"args": (argv,)})]
    # a project that does not load exits 1 in the parent, as without the flag
    assert cli.main([flagship + ".missing", "--multi-device"]) == 1
    assert len(calls) == 1


def test_multi_device_on_one_device_renders(flagship, monkeypatch):
    """As the JAX package's CLI (one device: the render without the flag),
    on the CPU whatever torch.cuda counts."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    (acc, wt), calls = _cli(monkeypatch, flagship, "--samples", "1", "--multi-device")
    assert calls >= 1 and float(wt.sum()) > 0

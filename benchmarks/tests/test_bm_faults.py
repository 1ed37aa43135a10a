"""A run with the timed path broken underneath must come out not correct.

Each test skips the harness's look for a card (``run.main(device="cpu")``)
and drives the rest of a short run on the CPU with one fault planted in
the program: a vocoder call that returns its state unchanged, an answer
altered where it is produced (a decoded frame, a vocoded frame, a frame of
the sampler's samples, the sampler's LPC prediction off by 1%), half of a
serving batch left out.  The neural session faults run in each neural
session cell, at bunch 1 and at bunch 8, each through the sampler entry
point its bunch selects.  (One stream a session has no batch to halve, and
no cell crosses chips.)  A sound run of each cell comes out correct, and
its last line keeps the result's shape; the bfloat16 control in the
program's place (``--control 1``) comes out not correct at every stage."""

from __future__ import annotations

import json

import pytest
import torch

from benchmarks import common, run


def _run(capsys, monkeypatch, workload, seconds, traffic=None, control=0):
    if traffic:
        cell = common.cell

        def small(bench, name):
            entry, config, t = cell(bench, name)
            return entry, config, dict(t, **traffic)
        monkeypatch.setattr(common, "cell", small)
    rc = run.main(["--workload", workload, "--seed", "2147483659",
                   "--seconds", str(seconds), "--control", str(control)],
                  device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    return line, err


SERVE = dict(streams=2, frames=10)


def test_bm_sound_runs_keep_the_result_shape(capsys, monkeypatch):
    line, err = _run(capsys, monkeypatch, "dsp_session", 6)
    assert line["correct"] is True
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"
    assert line["attempted"] == 2 and line["failed"] == 0
    assert set(line["metrics"]) == {"first_audio_ms_p50",
                                    "packet_step_ms_p50", "setup_s"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") and s.endswith(" ok") for s in tail)


def _dsp_state_unchanged(monkeypatch):
    from dss_tpu_torch.vocoder import lpcnet
    orig = lpcnet.dsp_synthesize_frames

    def stale(state, feats, noise=None):
        pcm, _ = orig(state, feats, noise)
        return pcm, state
    monkeypatch.setattr(lpcnet, "dsp_synthesize_frames", stale)


def _dsp_frame_altered(monkeypatch):
    from dss_tpu_torch.vocoder import lpcnet
    orig = lpcnet.dsp_synthesize_frames

    def altered(state, feats, noise=None):
        pcm, st = orig(state, feats, noise)
        pcm = pcm.clone()
        pcm[..., 1600:1760] += 0.05
        return pcm, st
    monkeypatch.setattr(lpcnet, "dsp_synthesize_frames", altered)


def _decoded_frame_altered(monkeypatch):
    from dss_tpu_torch.runtime import units
    orig = units._decode_padded

    def altered(model, data, T, mult, device):
        pred, feats = orig(model, data, T, mult, device)
        pred = pred.clone()
        pred[:, 10] += 0.05
        return pred, feats
    monkeypatch.setattr(units, "_decode_padded", altered)


def _net_state_unchanged(monkeypatch, module):
    orig = module.net_synthesize_frames

    def stale(model, params, state, *a, **kw):
        pcm, _ = orig(model, params, state, *a, **kw)
        return pcm, state
    monkeypatch.setattr(module, "net_synthesize_frames", stale)


def _samples_altered(monkeypatch, entry="sampler_frames"):
    from dss_tpu_torch.ops import sampler
    orig = getattr(sampler, entry)

    def altered(*a, **kw):
        carry, sig = orig(*a, **kw)
        sig = sig.clone()
        sig[:, 800:960] = torch.clamp(sig[:, 800:960] * 1.5 + 0.01, -1, 1)
        return carry, sig
    monkeypatch.setattr(sampler, entry, altered)


def _prediction_off(monkeypatch, entry="sampler_frames"):
    """The sampler's LPC taps 1% off: each sample's prediction moves by
    less than half a mu-law step at most levels."""
    from dss_tpu_torch.ops import sampler
    orig = getattr(sampler, entry)

    def off(w, carry, cond, lpc, *a, **kw):
        return orig(w, carry, cond, lpc * 1.01, *a, **kw)
    monkeypatch.setattr(sampler, entry, off)


def _half_batch(monkeypatch):
    from dss_tpu_torch.vocoder import net
    orig = net.net_synthesize_frames

    def half(model, params, state, feats, *a, **kw):
        pcm, st = orig(model, params, state, feats, *a, **kw)
        pcm = pcm.clone()
        pcm[pcm.shape[0] // 2:] = 0.0
        return pcm, st
    monkeypatch.setattr(net, "net_synthesize_frames", half)


@pytest.mark.parametrize("fault,expect", [
    (_dsp_state_unchanged, "state_gap"),
    (_dsp_frame_altered, "audio_gap_lsb"),
    (_decoded_frame_altered, "decoder_gap"),
])
def test_bm_dsp_session_faults(capsys, monkeypatch, fault, expect):
    fault(monkeypatch)
    line, _ = _run(capsys, monkeypatch, "dsp_session", 6)
    assert line["correct"] is False
    c = line["checks"][expect]
    assert c["value"] > c["limit"]


# Each neural session cell and the sampler entry point its bunch selects.
NET_SESSIONS = [("b1_session", "sampler_frames"),
                ("b8_session", "sampler_frames_bunched")]


@pytest.mark.parametrize("workload,entry", NET_SESSIONS)
@pytest.mark.parametrize("fault,expect", [
    ("state", "sampler_disagree"), ("samples", "sampler_disagree"),
    ("prediction", "pred_gap")])
def test_bm_net_session_faults(capsys, monkeypatch, workload, entry, fault,
                               expect):
    from dss_tpu_torch.runtime import units
    if fault == "state":
        _net_state_unchanged(monkeypatch, units)
    elif fault == "samples":
        _samples_altered(monkeypatch, entry)
    else:
        _prediction_off(monkeypatch, entry)
    line, _ = _run(capsys, monkeypatch, workload, 4)
    assert line["correct"] is False
    c = line["checks"][expect]
    assert c["value"] > c["limit"]


def test_bm_b1_serve_sound(capsys, monkeypatch):
    line, _ = _run(capsys, monkeypatch, "b1_serve15", 3, SERVE)
    assert line["correct"] is True and line["attempted"] >= 4
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}


@pytest.mark.parametrize("fault,expect", [
    ("state", "sampler_disagree"), ("samples", "sampler_disagree"),
    ("prediction", "pred_gap"), ("half", "audio_gap_lsb")])
def test_bm_b1_serve_faults(capsys, monkeypatch, fault, expect):
    from dss_tpu_torch.vocoder import net
    if fault == "state":
        _net_state_unchanged(monkeypatch, net)
    elif fault == "samples":
        _samples_altered(monkeypatch)
    elif fault == "prediction":
        _prediction_off(monkeypatch)
    else:
        _half_batch(monkeypatch)
    line, _ = _run(capsys, monkeypatch, "b1_serve15", 3, SERVE)
    assert line["correct"] is False
    c = line["checks"][expect]
    assert c["value"] > c["limit"]


def test_bm_serve_with_nothing_checked_is_not_correct():
    """A serving run that kept no checked run of steps judges nothing: it
    reads SENTINEL, not correct (the runner steps until it holds one)."""
    from benchmarks import checks
    numbers = checks.serve(dict(traffic=dict(frames=10)), [])
    assert set(numbers) == {"sampler_disagree", "pred_gap", "audio_gap_lsb"}
    assert not run.verdict(numbers)


@pytest.mark.parametrize("workload,seconds,traffic", [
    ("dsp_session", 6, None), ("b1_session", 4, None),
    ("b8_session", 4, None), ("b1_serve15", 3, SERVE)])
def test_bm_control_comes_out_not_correct(capsys, monkeypatch, workload,
                                          seconds, traffic):
    line, err = _run(capsys, monkeypatch, workload, seconds, traffic,
                     control=1)
    assert line["correct"] is False
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    stages = line["control"]
    assert set(stages) == ({"vocoder"} if traffic else
                           {"frontend", "decoder", "vocoder"})
    for stage in stages.values():
        assert stage["correct"] is False
        assert any(c["value"] > c["limit"]
                   for c in stage["checks"].values())
    assert "control vocoder check" in err


def test_bm_session_raises_on_another_bunch(capsys, monkeypatch):
    """A configuration that states another bunch than the vocoder the word
    path loads is refused, not judged by the wrong judge."""
    cell = common.cell

    def wrong(bench, name):
        entry, config, t = cell(bench, name)
        return entry, dict(config, vocoder=dict(config["vocoder"],
                                                bunch=8)), t
    monkeypatch.setattr(common, "cell", wrong)
    with pytest.raises(RuntimeError, match="bunch-1 vocoder"):
        run.main(["--workload", "b1_session", "--seed", "7", "--seconds",
                  "1"], device="cpu")

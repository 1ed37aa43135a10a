"""``b1_serve16``: the serving mix with one stream more than the card's
active clusters, reported under the ``.wave2`` metrics.

* Its traffic is ``serve_streams`` with 16 streams, nothing else changed.
* Each ``.wave2`` reader reads what its serving counterpart reads.
* A short run on the CPU (two streams of ten frames: the same runner and
  checks at a size the CPU holds) reports exactly ``audio_s_per_s.wave2``
  and ``setup_s`` and is correct; with each serving fault planted (a state
  left unchanged, sampled frames altered, LPC taps 1% off, half the batch
  left out) and with the bfloat16 control in the program's place it is
  not correct."""

from __future__ import annotations

import pytest

from benchmarks import common

WAVE2 = {"audio_s_per_s.wave2": "audio_s_per_s",
         "vocoder.host_ms_per_step.wave2": "vocoder.host_ms_per_step",
         "roofline.k2.wave2": "roofline.k2.serve",
         "mfu.wave2": "mfu.serve",
         "idle_share.wave2": "idle_share.serve"}

faults = common.load_module(common.HERE / "tests" / "test_bm_faults.py",
                            "bench_wave2_faults")


def test_bm_serve16_reads_sixteen_streams():
    entry, config, traffic = common.cell(common.benchmark(), "b1_serve16")
    base = common.load_json(common.HERE / "traffic" / "serve_streams.json")
    assert config["name"] == "lpcnet_b1" and entry["chips"] == 1
    assert traffic == dict(base, streams=16)


def test_bm_serve16_reports_the_wave2_metrics():
    bench = common.benchmark()
    e2e = [m["name"] for m in common.metrics_of(bench, "b1_serve16",
                                                "end_to_end")]
    per = [m["name"] for m in common.metrics_of(bench, "b1_serve16",
                                                "per_layer")]
    assert e2e == ["setup_s", "audio_s_per_s.wave2"]
    assert sorted(per) == sorted(n for n in WAVE2 if n != e2e[1])
    for w in bench["workloads"]:
        if w["name"] != "b1_serve16":
            assert not any(m["name"] in WAVE2 for kind in
                           ("end_to_end", "per_layer")
                           for m in common.metrics_of(bench, w["name"],
                                                      kind))


@pytest.mark.parametrize("name", sorted(WAVE2))
def test_bm_wave2_reads_as_its_serving_metric(name):
    ctx = dict(config=common.cell(common.benchmark(), "b1_serve16")[1])
    trace = dict(busy_s=40.9, window_s=51.0, by_name={
        "void lpcnet_sampler_kernel<1>(Params)": (756, 36.3),
        "elementwise_kernel": (3024, 2.1)})
    recs = [dict(kind="serve", streams=16, frames=50, steps=756,
                 audio_s=6048.0, window_s=51.0, trace=trace),
            dict(kind="serve", streams=16, frames=50, steps=756,
                 audio_s=6048.0, window_s=51.0),
            dict(kind="session", word_span_s=[0.2])]
    got = [common.reader(name).read(r, ctx) for r in recs]
    assert got == [common.reader(WAVE2[name]).read(r, ctx) for r in recs]
    assert got[0] is not None and got[2] is None


def test_bm_serve16_sound_run(capsys, monkeypatch):
    line, _ = faults._run(capsys, monkeypatch, "b1_serve16", 3, faults.SERVE)
    assert line["correct"] is True and line["attempted"] >= 4
    assert set(line["metrics"]) == {"audio_s_per_s.wave2", "setup_s"}


@pytest.mark.parametrize("fault,expect", [
    ("state", "sampler_disagree"), ("samples", "sampler_disagree"),
    ("prediction", "pred_gap"), ("half", "audio_gap_lsb")])
def test_bm_serve16_faults(capsys, monkeypatch, fault, expect):
    from dss_tpu_torch.vocoder import net
    if fault == "state":
        faults._net_state_unchanged(monkeypatch, net)
    elif fault == "samples":
        faults._samples_altered(monkeypatch)
    elif fault == "prediction":
        faults._prediction_off(monkeypatch)
    else:
        faults._half_batch(monkeypatch)
    line, _ = faults._run(capsys, monkeypatch, "b1_serve16", 3, faults.SERVE)
    assert line["correct"] is False
    c = line["checks"][expect]
    assert c["value"] > c["limit"]


def test_bm_serve16_control_comes_out_not_correct(capsys, monkeypatch):
    line, err = faults._run(capsys, monkeypatch, "b1_serve16", 3,
                            faults.SERVE, control=1)
    assert line["correct"] is False
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert set(line["control"]) == {"vocoder"}
    stage = line["control"]["vocoder"]
    assert stage["correct"] is False
    assert any(c["value"] > c["limit"] for c in stage["checks"].values())
    assert "control vocoder check" in err

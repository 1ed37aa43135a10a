"""The port's entry point and packet codec, on the CPU: the INI reader of
dss_tpu_torch.apps.decode_online against config/debug_settings.ini, and
the BCI2000 packet decoder against the JAX package's encoder."""

import configparser
from pathlib import Path

import numpy as np
import pytest
import torch

from dss_tpu.native import pack_packet
from dss_tpu_torch.apps.decode_online import PACKAGED_VOCODER, Neuroprosthesis, \
    build_settings
from dss_tpu_torch.runtime.units import interpret_bci2000_packet

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
DEBUG_INI = REPO / "config" / "debug_settings.ini"


def _ini(tmp_path, **overrides):
    cfg = configparser.ConfigParser()
    cfg.read(DEBUG_INI)
    for k, v in overrides.items():
        cfg.set("Decoding", k, v)
    path = tmp_path / "cfg.ini"
    with open(path, "w") as fd:
        cfg.write(fd)
    return str(path)


@pytest.mark.parametrize("device, fused_frontend, fused_decoder, units", [
    # auto, as the shipped INI says: the separate chain on the CPU; on the
    # card a fused packet path, and a separate word path for dsp.
    ("cpu", "auto", "auto", ("FEATURE_EXTRACTOR", "SPEECH_FILTER",
                             "DECODING_MODEL", "WAVEFORM_GENERATOR")),
    ("cuda", "auto", "auto", ("FUSED_FRONTEND", "DECODING_MODEL",
                              "WAVEFORM_GENERATOR")),
    ("cpu", "true", "false", ("FUSED_FRONTEND", "DECODING_MODEL",
                              "WAVEFORM_GENERATOR")),
    ("cpu", "false", "true", ("FEATURE_EXTRACTOR", "SPEECH_FILTER",
                              "DECODE_VOCODE")),
    ("cpu", "true", "true", ("FUSED_FRONTEND", "DECODE_VOCODE")),
    ("cpu", "false", "false", ("FEATURE_EXTRACTOR", "SPEECH_FILTER",
                               "DECODING_MODEL", "WAVEFORM_GENERATOR")),
])
def test_debug_ini_builds_the_shipped_configuration(tmp_path, device,
                                                    fused_frontend,
                                                    fused_decoder, units):
    """The shipped debug INI (vocoder_backend = dsp) builds its system:
    the fused_* switches pick the units as the JAX app does (auto: fused
    packet path on cuda; fused word path only on cuda with net, so never
    with dsp), the others are removed, every edge joins two present units,
    and the vocoder is the weight-free dsp one.  The "cuda" settings are
    built on the CPU: nothing touches a device before the units start."""
    ini = str(DEBUG_INI) if fused_frontend == fused_decoder == "auto" \
        else _ini(tmp_path, fused_frontend=fused_frontend,
                  fused_decoder=fused_decoder)
    s = build_settings(ini, "run", device=device)
    assert s.vocoder_backend == "dsp" and s.vocoder_weights is None
    assert s.fused_frontend == ("FUSED_FRONTEND" in units)
    assert s.fused_decoder == ("DECODE_VOCODE" in units)
    system = Neuroprosthesis(s)
    system.configure()
    optional = {"FEATURE_EXTRACTOR", "SPEECH_FILTER", "FUSED_FRONTEND",
                "DECODING_MODEL", "WAVEFORM_GENERATOR", "DECODE_VOCODE"}
    present = {n for n in optional if n in vars(system)}
    assert present == set(units)
    alive = set(map(id, system.units()))
    edges = system.network()
    assert len(edges) == (4 if s.fused_frontend else 5) + \
        (4 if s.fused_decoder else 5)
    for a, b in edges:
        assert id(a.unit) in alive and id(b.unit) in alive
    if s.fused_decoder:
        assert system.DECODE_VOCODE.SETTINGS.vocoder_backend == "dsp"
    else:
        assert system.WAVEFORM_GENERATOR.SETTINGS.backend == "dsp"
        assert system.WAVEFORM_GENERATOR.SETTINGS.device == device
    assert system.LOUDSPEAKER.SETTINGS.budget_path.endswith(
        "latency_budget.json")


def test_ini_with_net_backend_builds_the_fused_system(tmp_path):
    """With vocoder_backend = net and both fused_* switches true, the
    settings carry the INI's values, the shipped flagship vocoder by
    default, and the system wires the fused units and every log tap."""
    s = build_settings(_ini(tmp_path, vocoder_backend="net",
                            segment_prewarm_frames="[50, 100]",
                            fused_frontend="true", fused_decoder="true"),
                       "run", device="cpu")
    assert (s.fs, s.package_size, s.port) == (1000, 40, 5556)
    assert s.vocoder_weights == str(PACKAGED_VOCODER)
    assert PACKAGED_VOCODER.exists()
    assert s.segment_prewarm_frames == (50, 100)
    assert s.destination_dir.endswith("run")
    system = Neuroprosthesis(s)
    system.configure()
    edges = system.network()
    assert len(edges) == 8
    fe = system.FUSED_FRONTEND.SETTINGS
    assert fe.nb_features == 64 and fe.device == "cpu"
    assert system.DECODE_VOCODE.SETTINGS.prewarm_frames == (50, 100)


def test_ini_with_a_bunched_checkpoint_runs_the_bunched_vocoder(tmp_path):
    """``vocoder_weights = weights/vocoder_speech_b8.npz`` in the INI: the
    word unit loads the shipped b8 checkpoint, reads bunch 8 from it,
    prepares the bunched sampler's weights and carries an [1, 8] excitation
    history (its warm-up block runs the bunched sampler, on the CPU the
    plain version)."""
    weights = str(REPO / "weights" / "vocoder_speech_b8.npz")
    s = build_settings(_ini(tmp_path, vocoder_backend="net",
                            vocoder_weights=weights,
                            segment_prewarm_frames="[]",
                            fused_decoder="true"),
                       "run", device="cpu")
    assert s.vocoder_weights == weights
    system = Neuroprosthesis(s)
    system.configure()
    unit = system.DECODE_VOCODE
    assert unit.SETTINGS.vocoder_weights == weights
    unit.initialize()
    try:
        assert unit._voc_model.bunch == 8
        assert unit._sampler_w["emb"].shape == (17, 256, 1152)
        assert unit._sampler_w["corr"].shape == (7, 2, 256, 256)
        assert tuple(unit._voc_state.exc_idx.shape) == (1, 8)
        assert unit._voc_state.frame_ctr == 0
    finally:
        unit.shutdown()


def test_bci2000_packet_decoder_matches_encoder(rng):
    """GenericSignal packets from the JAX package's encoder decode to the
    same [samples, channels] float64 array (float32 on the wire)."""
    data = rng.normal(size=(40, 129)).astype(np.float32)
    got = interpret_bci2000_packet(pack_packet(data))
    assert got.dtype == np.float64 and got.shape == (40, 129)
    np.testing.assert_array_equal(got, data.astype(np.float64))

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


def test_debug_ini_with_dsp_backend_is_refused():
    """The shipped debug INI selects the DSP vocoder, which is not ported:
    the port says so instead of running something else."""
    with pytest.raises(ValueError, match="vocoder_backend"):
        build_settings(str(DEBUG_INI), "run")


def test_ini_with_net_backend_builds_the_fused_system(tmp_path):
    """With vocoder_backend = net the settings carry the INI's values, the
    shipped flagship vocoder by default, and the system wires the fused
    units and every log tap."""
    s = build_settings(_ini(tmp_path, vocoder_backend="net",
                            segment_prewarm_frames="[50, 100]"),
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


def test_bci2000_packet_decoder_matches_encoder(rng):
    """GenericSignal packets from the JAX package's encoder decode to the
    same [samples, channels] float64 array (float32 on the wire)."""
    data = rng.normal(size=(40, 129)).astype(np.float32)
    got = interpret_bci2000_packet(pack_packet(data))
    assert got.dtype == np.float64 and got.shape == (40, 129)
    np.testing.assert_array_equal(got, data.astype(np.float64))

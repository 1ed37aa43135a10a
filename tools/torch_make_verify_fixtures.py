"""Fixtures for a closed-loop verify run of the PyTorch/CUDA port
(counterpart of tools/make_verify_fixtures.py).

Writes into OUT (default ``<temp dir>/verify_e2e``):

* ``KeywordSynthesis_Overt_R01.mat``: 6 s of 129-channel noise at 1 kHz
  with a loud burst at 2.0-3.5 s (and the audio channel), a session the
  replay amplifier streams;
* ``vad_threshold.npz``: a hand-made 2 x 150 LSTM checkpoint that acts as
  a deterministic threshold VAD (speech iff mean(feature) > -2.5), so the
  whole online graph runs without training;

then loads the checkpoint into the port's
``UnidirectionalVoiceActivityDetector`` and checks it on a feature ramp.

    python tools/torch_make_verify_fixtures.py [OUT] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
from scipy.io import savemat

REPO = Path(__file__).resolve().parent.parent
H, IN = 150, 64   # the deployed nVAD's widths


def threshold_vad(s: float = 10.0, theta: float = -2.5) -> dict:
    """The threshold VAD as a torch-layout state_dict of numpy arrays.
    Unit 0 of each layer carries tanh(s * (mean(x) - theta)); the gates
    are held open or closed by large biases, so the cell is stateless;
    the classifier maps the sign of unit 0 to the speech logit."""
    sd = {}
    for layer, in_size in ((0, IN), (1, H)):
        w_ih = np.zeros((4 * H, in_size), np.float32)
        b_ih = np.zeros(4 * H, np.float32)
        b_ih[0:H] = 10.0           # input gate open
        b_ih[H:2 * H] = -10.0      # forget gate closed (stateless)
        b_ih[3 * H:4 * H] = 10.0   # output gate open
        if layer == 0:
            w_ih[2 * H, :] = s / IN          # g gate, unit 0: s * mean(x)
            b_ih[2 * H] = -s * theta
        else:
            w_ih[2 * H, 0] = s               # pass unit 0's sign through
        sd[f"lstm.weight_ih_l{layer}"] = w_ih
        sd[f"lstm.weight_hh_l{layer}"] = np.zeros((4 * H, H), np.float32)
        sd[f"lstm.bias_ih_l{layer}"] = b_ih
        sd[f"lstm.bias_hh_l{layer}"] = np.zeros(4 * H, np.float32)
    cls_w = np.zeros((2, H), np.float32)
    cls_w[0, 0], cls_w[1, 0] = -5.0, 5.0
    sd["classifier.weight"] = cls_w
    sd["classifier.bias"] = np.zeros(2, np.float32)
    return sd


def write_session(path: Path, seconds: float = 6.0, burst=(2.0, 3.5),
                  seed: int = 7) -> None:
    """The 6 s BCI2000-layout session with one loud burst."""
    fs = 1000
    rng = np.random.default_rng(seed)
    T = int(seconds * fs)
    envelope = np.full(T, 0.05)
    envelope[int(burst[0] * fs):int(burst[1] * fs)] = 2.0
    signal = rng.normal(size=(T, 129)) * envelope[:, None]
    code = np.zeros(T, np.int16)
    code[int(burst[0] * fs):int(burst[1] * fs)] = 1
    savemat(str(path), {
        "signal": signal,
        "parameters": {
            "SamplingRate": {"NumericValue": fs},
            "SourceChGain": {"NumericValue": np.ones(129)},
            "Stimuli": {"Value": np.array([["Enter"]])},
        },
        "states": {"StimulusCode": code},
    })


def check_vad(vad_path: Path, device=None) -> list:
    """The checkpoint through the port's nVAD on a six-frame ramp (quiet,
    quiet, loud, loud, quiet, quiet): -> its labels, which must be
    0 0 1 1 0 0."""
    sys.path.insert(0, str(REPO))
    import torch

    from dss_tpu_torch.device import resolve_device
    from dss_tpu_torch.models.vad import UnidirectionalVoiceActivityDetector
    from dss_tpu_torch.models.torch_port import load_checkpoint

    dev = resolve_device(device)
    vad = UnidirectionalVoiceActivityDetector(2, H, IN)
    vad.load_state_dict(load_checkpoint(str(vad_path), 2,
                                        bidirectional=False,
                                        head_name="classifier"))
    vad.to(dev).eval()
    x = torch.full((1, 6, IN), -4.6, device=dev)
    x[0, 2:4] = -0.9
    with torch.no_grad():
        logits, _ = vad(x)
    labels = logits.argmax(-1).cpu().tolist()
    if labels != [[0, 0, 1, 1, 0, 0]]:
        raise AssertionError(f"threshold VAD labels {labels}, expected "
                             f"[[0, 0, 1, 1, 0, 0]]")
    return labels


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(
        description="Write the closed-loop verify fixtures (a session with "
                    "one burst, a threshold-VAD checkpoint) and check the "
                    "checkpoint on the port's nVAD.")
    parser.add_argument("out", nargs="?", default=None,
                        help="Output directory (default: <temp dir>/"
                             "verify_e2e).")
    parser.add_argument("--device", default=None,
                        help="Torch device of the check (default: cuda).")
    args = parser.parse_args(argv)
    out = Path(args.out) if args.out else \
        Path(tempfile.gettempdir()) / "verify_e2e"
    out.mkdir(parents=True, exist_ok=True)
    write_session(out / "KeywordSynthesis_Overt_R01.mat")
    np.savez(out / "vad_threshold.npz", **threshold_vad())
    labels = check_vad(out / "vad_threshold.npz", args.device)
    print("labels:", labels, "(expect 0 0 1 1 0 0)")
    print("fixtures ok:", out)
    return out


if __name__ == "__main__":
    main()

"""Where the sampler kernel and its plain version get their mu-law levels,
and what float32 ``torch.pow`` levels do to a long greedy run.

1. The 256 levels three ways: exact (sign(y) (256^|y| - 1) / 255 in
   float64, rounded once to float32: ``vocoder/mulaw.py``'s table); the
   same formula evaluated in float32 by ``torch.pow`` on the card (what the
   plain version used before it read the table); and the kernel's own,
   read from its samples with every LPC tap 0 (a sample is then its
   excitation's level) under noise that reaches all 256 levels.
2. An imported released-width checkpoint (tests/torch_xiph.py) greedy over
   ``--frames`` frames through the kernel, against the plain version on
   the card in float32 with the exact levels, in float32 with the
   ``torch.pow`` levels, and in float64 with the exact levels: the largest
   sample difference of each pair.

Needs an H100 and nvcc:

    python tools/torch_mulaw_levels.py [--frames 50] [--out FILE.json]
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from dss_tpu_torch.ops import sampler as smp  # noqa: E402
from dss_tpu_torch.vocoder import net as tnet  # noqa: E402
from dss_tpu_torch.vocoder.interop import params_from_datasets  # noqa: E402
from dss_tpu_torch.vocoder.lpc import bands_from_cepstrum, \
    lpc_from_bands  # noqa: E402
from dss_tpu_torch.vocoder.lpcnet import _load_params  # noqa: E402
from dss_tpu_torch.vocoder.mulaw import LEVELS  # noqa: E402
from torch_xiph import xiph_datasets  # noqa: E402


def pow_levels(idx: torch.Tensor) -> torch.Tensor:
    """The levels as float32 ``torch.pow`` gives them on ``idx``'s device."""
    y = idx.float() / 255 * 2.0 - 1.0
    return torch.sign(y) * (torch.pow(256.0, y.abs()) - 1.0) / 255.0


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=50)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    dev = torch.device("cuda")
    out = {}

    exact = LEVELS.astype(np.float64)
    powed = pow_levels(torch.arange(256, device=dev)).double().cpu().numpy()
    out["pow_levels"] = dict(differ=int((powed != exact).sum()),
                             max_abs=float(np.abs(powed - exact).max()))

    params, model = params_from_datasets(xiph_datasets(0))
    p = _load_params(params, dev)
    w = tnet.sampler_weights_for(model, p)
    T = args.frames
    g = torch.Generator().manual_seed(T)
    feats = torch.randn((1, T, 20), generator=g) * 0.3
    feats[..., 0] -= 4.0
    feats = feats.to(dev)
    cond = model.condition(p, feats).transpose(0, 1).contiguous()
    lpc, _ = lpc_from_bands(bands_from_cepstrum(feats[..., :18]))
    lpc = lpc.transpose(0, 1).contiguous()
    st = tnet.net_vocoder_init(model, 1, device=dev)
    carry = (st.h_a, st.h_b, st.sig_mem, st.exc_idx)

    noise = 100.0 * torch.randn((T, 160, 1, 256),
                                generator=torch.Generator().manual_seed(3))
    _, ks0 = smp.sampler_frames(w, carry, cond, torch.zeros_like(lpc),
                                torch.ones((T, 1), device=dev), noise.to(dev))
    ks0 = ks0[0].double().cpu().numpy()
    seen = np.abs(ks0[:, None] - exact[None]).argmin(1)
    out["kernel_levels"] = dict(
        levels_seen=len(set(seen.tolist())),
        equal_to_exact=bool(np.array_equal(ks0, exact[seen])),
        max_abs=float(np.abs(ks0 - exact[seen]).max()))

    temp = -torch.ones((T, 1), device=dev)
    _, ks = smp.sampler_frames(w, carry, cond, lpc, temp, None)
    _, exact32 = smp.sampler_frames_plain(w, carry, cond, lpc, temp, None)
    smp.mulaw_decode, kept = pow_levels, smp.mulaw_decode
    try:
        _, pow32 = smp.sampler_frames_plain(w, carry, cond, lpc, temp, None)
    finally:
        smp.mulaw_decode = kept
    w64 = {k: v.double() for k, v in w.items() if torch.is_tensor(v)}
    carry64 = tuple(x.double() if x.is_floating_point() else x
                    for x in carry)
    _, exact64 = smp.sampler_frames_plain(w64, carry64, cond.double(),
                                          lpc.double(), temp.double(), None)
    runs = {"kernel": ks, "plain_f32": exact32, "plain_f32_pow": pow32,
            "plain_f64": exact64}
    runs = {k: v[0].double().cpu().numpy() for k, v in runs.items()}
    out["greedy"] = {
        f"{a}_vs_{b}": float(np.abs(runs[a] - runs[b]).max())
        for a, b in (("kernel", "plain_f32"), ("kernel", "plain_f32_pow"),
                     ("kernel", "plain_f64"), ("plain_f32", "plain_f64"),
                     ("plain_f32_pow", "plain_f64"))}
    out["frames"] = T
    print(json.dumps(out))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

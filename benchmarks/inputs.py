"""The inputs a run makes from its seed and hands to both the program and
the reference: the ECoG session with its word schedule, the nVAD and
decoder weights, the serving cell's feature pool.

The word schedule is the same set of burst lengths and gaps for every seed,
in an order the seed draws: a seed changes the noise and the order, not
the amount of work."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

H_VAD, IN = 150, 64


def threshold_vad(s: float = 10.0, theta: float = -2.5
                  ) -> Dict[str, np.ndarray]:
    """A 2 x 150 LSTM checkpoint (torch layout) that acts as a threshold
    VAD: speech iff mean(features) > theta.  Unit 0 of each layer carries
    tanh(s * (mean(x) - theta)); the gates are held open or closed by large
    biases, so the cell is stateless; the classifier maps unit 0's sign to
    the speech logit."""
    H = H_VAD
    sd = {}
    for layer, in_size in ((0, IN), (1, H)):
        w_ih = np.zeros((4 * H, in_size), np.float32)
        b_ih = np.zeros(4 * H, np.float32)
        b_ih[0:H] = 10.0
        b_ih[H:2 * H] = -10.0
        b_ih[3 * H:4 * H] = 10.0
        if layer == 0:
            w_ih[2 * H, :] = s / IN
            b_ih[2 * H] = -s * theta
        else:
            w_ih[2 * H, 0] = s
        sd[f"lstm.weight_ih_l{layer}"] = w_ih
        sd[f"lstm.weight_hh_l{layer}"] = np.zeros((4 * H, H), np.float32)
        sd[f"lstm.bias_ih_l{layer}"] = b_ih
        sd[f"lstm.bias_hh_l{layer}"] = np.zeros(4 * H, np.float32)
    cls = np.zeros((2, H), np.float32)
    cls[0, 0], cls[1, 0] = -5.0, 5.0
    sd["classifier.weight"] = cls
    sd["classifier.bias"] = np.zeros(2, np.float32)
    return sd


def decoder_weights(seed: int, layers: int = 2, hidden: int = 100,
                    inputs: int = 64, outputs: int = 20,
                    c0_bias: float = 0.0) -> Dict[str, np.ndarray]:
    """A bidirectional decoder checkpoint (torch layout) drawn from the
    seed as torch initializes one (uniform in +-1/sqrt(fan)); the first
    output's bias, the energy cepstrum c0, is set to ``c0_bias``."""
    rng = np.random.default_rng([int(seed), 1])
    sd = {}
    b = 1.0 / np.sqrt(hidden)
    width = inputs
    for k in range(layers):
        for sfx in ("", "_reverse"):
            for name, shape in (("weight_ih", (4 * hidden, width)),
                                ("weight_hh", (4 * hidden, hidden)),
                                ("bias_ih", (4 * hidden,)),
                                ("bias_hh", (4 * hidden,))):
                sd[f"lstm.{name}_l{k}{sfx}"] = rng.uniform(
                    -b, b, shape).astype(np.float32)
        width = 2 * hidden
    b = 1.0 / np.sqrt(width)
    sd["regressor.weight"] = rng.uniform(-b, b, (outputs, width)).astype(
        np.float32)
    bias = rng.uniform(-b, b, outputs).astype(np.float32)
    bias[0] = c0_bias
    sd["regressor.bias"] = bias
    return sd


def word_schedule(seed: int, traffic: dict, seconds: float
                  ) -> List[Tuple[float, float]]:
    """(start, stop) seconds of each attempted word in a window of
    ``seconds``: evenly spaced burst lengths and gaps in the mix's ranges,
    as many as fit between the lead-in and the tail, in the seed's order."""
    lo_b, hi_b = traffic["burst_s"]
    lo_g, hi_g = traffic["gap_s"]
    room = seconds - traffic["lead_s"] - traffic["tail_s"]
    n = max(1, int(room // ((lo_b + hi_b) / 2 + (lo_g + hi_g) / 2)))
    bursts = np.linspace(lo_b, hi_b, n)
    gaps = np.linspace(lo_g, hi_g, n)
    rng = np.random.default_rng([int(seed), 2])
    bursts, gaps = rng.permutation(bursts), rng.permutation(gaps)
    out, t = [], float(traffic["lead_s"])
    for k in range(n):
        out.append((t, t + float(bursts[k])))
        t += float(bursts[k]) + (float(gaps[k]) if k + 1 < n else 0.0)
    return out


def session(seed: int, traffic: dict, seconds: float) -> np.ndarray:
    """The raw stream of a window: [N, channels] float32 values (N the
    window's whole packets), Gaussian noise at the quiet envelope with the
    schedule's bursts at the loud one."""
    fs, P = traffic["fs"], traffic["package_size"]
    N = int(seconds * fs) // P * P
    env = np.full(N, traffic["noise_envelope"], np.float32)
    for a, b in word_schedule(seed, traffic, seconds):
        env[int(a * fs):int(b * fs)] = traffic["burst_envelope"]
    rng = np.random.default_rng([int(seed), 3])
    x = rng.standard_normal((N, traffic["channels"]), dtype=np.float32)
    return x * env[:, None]

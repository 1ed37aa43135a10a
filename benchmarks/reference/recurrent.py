"""Plain reference of the two recurrent models and the segment logic
between them.

* An LSTM layer as its equations (gate order i, f, g, o; two bias
  vectors), written as a loop over time in plain PyTorch on the CPU: the
  nVAD (2 x 150, unidirectional, Linear(150 -> 2), argmax) and the decoder
  (2 x 100, bidirectional, Linear(200 -> 20)) of Angrick et al., Sci Rep
  14:9617, 2024 (reference ``decode_online.py:119,126``).
* The online label smoothing (majority of 11 frames at 0.6) and segment
  history (a segment closes once ``context`` non-speech frames followed its
  speech; it spans ``2 * context`` frames plus its speech frames), frozen
  copies of the reference's ring buffers, fed one packet at a time.

``dtype=torch.bfloat16`` is the control.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .precision import no_tf32


def lstm_layer(x: torch.Tensor, w_ih, w_hh, b_ih, b_hh,
               reverse: bool = False) -> torch.Tensor:
    """x [T, in] -> h [T, H] from zero state."""
    H = w_hh.shape[1]
    gx = x @ w_ih.T + b_ih + b_hh
    h = x.new_zeros(H)
    c = x.new_zeros(H)
    out = [None] * len(x)
    order = range(len(x) - 1, -1, -1) if reverse else range(len(x))
    for t in order:
        g = gx[t] + w_hh @ h
        i, f, gg, o = g[:H], g[H:2 * H], g[2 * H:3 * H], g[3 * H:]
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return torch.stack(out)


def _w(sd: Dict[str, np.ndarray], key: str, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(sd[key], np.float32)).to(dtype)


@torch.no_grad()
@no_tf32()
def lstm_stack(sd, x: np.ndarray, layers: int, bidirectional: bool,
               head: str, dtype=torch.float32) -> np.ndarray:
    """A stacked (bi)directional LSTM and its Linear head over x [T, in]
    from zero state, with the weights of a torch-layout state dict."""
    h = torch.as_tensor(np.asarray(x, np.float32)).to(dtype)
    for k in range(layers):
        outs = []
        for suffix in (("", "_reverse") if bidirectional else ("",)):
            outs.append(lstm_layer(
                h, *(_w(sd, f"lstm.{n}_l{k}{suffix}", dtype) for n in
                     ("weight_ih", "weight_hh", "bias_ih", "bias_hh")),
                reverse=bool(suffix)))
        h = torch.cat(outs, dim=-1)
    y = h @ _w(sd, f"{head}.weight", dtype).T + _w(sd, f"{head}.bias", dtype)
    return y.to(torch.float32).numpy()


def vad_labels(sd, feats: np.ndarray, dtype=torch.float32) -> np.ndarray:
    """The nVAD's speech labels (0/1) of a feature stream [T, 64]."""
    logits = lstm_stack(sd, feats, 2, False, "classifier", dtype)
    return np.argmax(logits, axis=-1).astype(np.int32)


def decode(sd, segment: np.ndarray, dtype=torch.float32) -> np.ndarray:
    """The decoder's acoustic features [T, 20] of one segment [T, 64]."""
    return lstm_stack(sd, segment, 2, True, "regressor", dtype)


class _Smoothing:
    def __init__(self, nb_features: int, context: int, threshold=0.6):
        self.w = 2 * context + 1
        self.threshold = threshold
        self.buffer = np.zeros((self.w, nb_features), np.float32)
        self.labels = np.zeros(self.w, bool)
        self.write = 2 * context

    def insert(self, data, labels):
        n, w = len(labels), self.w
        order = (self.write + np.arange(w)) % w
        tl = np.concatenate([self.labels[order], np.asarray(labels, bool)])
        td = np.concatenate([self.buffer[order],
                             np.asarray(data, np.float32)])
        prefix = np.concatenate([[0], np.cumsum(tl)])
        counts = prefix[w + 1 + np.arange(n)] - prefix[1 + np.arange(n)]
        self.write = (self.write + n) % w
        restore = (self.write + np.arange(w)) % w
        self.labels[restore] = tl[n:n + w]
        self.buffer[restore] = td[n:n + w]
        return td[1:n + 1].copy(), counts / w >= self.threshold


class _History:
    def __init__(self, nb_features: int, size: int, context: int):
        self.buffer = np.zeros((size, nb_features), np.float32)
        self.write = 0
        self.context = context
        self.speech = 0
        self.future = 0

    def insert(self, data, labels) -> List[np.ndarray]:
        size = len(self.buffer)
        out = []
        for i in range(len(labels)):
            self.buffer[self.write] = data[i]
            self.write = (self.write + 1) % size
            if labels[i]:
                self.speech += 1
                continue
            if self.speech > 0:
                self.future += 1
                if self.future >= self.context:
                    length = 2 * self.context + self.speech
                    idx = (self.write - length + np.arange(length)) % size
                    out.append(self.buffer[idx].copy())
                    self.speech = self.future = 0
        return out


def segments(feats: np.ndarray, labels: np.ndarray, packet_frames: List[int],
             context: int = 50, buffer_size: int = 2000,
             smoothing_context: int = 5) -> List[np.ndarray]:
    """The speech segments [T_k, 64] the online path closes over a stream of
    features and labels arriving ``packet_frames`` frames at a time."""
    sm = _Smoothing(feats.shape[1], smoothing_context)
    hist = _History(feats.shape[1], buffer_size, context)
    out, i = [], 0
    for n in packet_frames:
        d, lab = sm.insert(feats[i:i + n], labels[i:i + n])
        out += hist.insert(d, lab)
        i += n
    return out

"""Weight interop with the xiph LPCNet ecosystem (counterpart of
dss_tpu/vocoder/interop.py).

Released LPCNet weights come from a Keras checkpoint (``lpcnet*.h5``).  This
module maps that layer layout into the port's ``LPCNetModel`` parameters, so
an imported model runs through the port's synthesis stack
(``LPCNet(backend="net", model=model, weights=params)``, the sampler kernel
on the card), and back out, so native checkpoints round-trip through the
same container.

Layer map (upstream names of xiph/LPCNet ``lpcnet.py`` / ``dump_lpcnet.py``):

  ==================  ==========================================
  xiph layer          LPCNetModel params
  ==================  ==========================================
  embed_sig           emb_sig, emb_pred, emb_exc (ONE shared
                      [256, E] table upstream, fanned out to the
                      three slots)
  embed_pitch         emb_pitch [256, 64]: the frame net sees
                      concat(features, embed_pitch(period)) with
                      period = round(50 * f[18] + 100) through
                      same-padded convs (net.LPCNetModel.condition)
  feature_conv1/2     conv1_w/b, conv2_w/b (Conv1D kernel
                      [W, in, out] -> [W * in, out], oldest tap
                      first)
  feature_dense1/2    fc1_w/b, fc2_w/b
  gru_a               gru_a_wx/wh/bx/bh: Keras gate order (z, r, h)
                      reordered to (r, z, n); reset_after bias
                      [2, 3H] -> bx, bh
  gru_b               gru_b_wx/wh/bx/bh (the same reorder)
  dual_fc (MDense)    fc_out{1,2}_w [in, 256], the biases INSIDE
                      the tanh fc_out{1,2}_b, the factors
                      fc_out{1,2}_g; fc_out_b (the outside bias)
                      zeros
  ==================  ==========================================

Both GRUs must be ``reset_after`` (upstream trains them so); a 1-D GRU bias
is refused, because the reset-before recurrence has another candidate state.

Each direction is split at the file: ``params_from_datasets`` and
``native_params_from_datasets`` hold the map from a file's datasets (a dict
of arrays keyed by their path in the file), ``datasets_from_params`` the map
back; ``import_lpcnet_h5``, ``reimport_native_h5`` and ``export_lpcnet_h5``
read or write the file around them.  h5py is imported only there, so the
map runs where h5py is not installed.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Tuple

import numpy as np

from .lpc import NB_FEATURES
from .mulaw import MULAW_LEVELS
from .net import CONV_WIDTH, LPCNetModel

logger = logging.getLogger("dss_tpu_torch.vocoder.interop")

PITCH_EMBED_DIM = 64
ROOT = "model_weights"       # the layers' group in a full-model save
EXTRA = "dss_tpu_extra"      # native parameters upstream has no slot for

# Keras gate order is (z, r, h); LPCNetModel uses (r, z, n).  The swap of
# the first two blocks is its own inverse, so it maps both ways.
_KERAS_TO_NATIVE = (1, 0, 2)
# Per-lag and per-sub-sample parameters of bunched checkpoints.
_BUNCHED = re.compile(r"_(l|b)\d+$")

Datasets = Dict[str, np.ndarray]


def _reorder_gates(w: np.ndarray, units: int) -> np.ndarray:
    """Swap the first two of the 3 gate blocks along the last axis."""
    blocks = [w[..., k * units:(k + 1) * units] for k in _KERAS_TO_NATIVE]
    return np.concatenate(blocks, axis=-1)


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("dss_tpu_torch.vocoder.interop needs h5py to read "
                          "or write .h5 checkpoints, and h5py is not "
                          "installed; params_from_datasets and "
                          "datasets_from_params take the datasets as a "
                          "dict") from e
    return h5py


def read_datasets(path: str) -> Datasets:
    """Every dataset of an .h5 file, keyed by its path from the root."""
    h5py = _h5py()
    out: Datasets = {}
    with h5py.File(path, "r") as f:
        def visit(name, item):
            if isinstance(item, h5py.Dataset):
                out[name] = np.asarray(item)
        f.visititems(visit)
    return out


def _layers(datasets: Datasets) -> Datasets:
    """The datasets that hold the layers: those under ``model_weights/`` in
    a full-model save, else all of them (a weights-only save), keyed by
    their path below that root."""
    prefix = ROOT + "/"
    if any(k.startswith(prefix) for k in datasets):
        return {k[len(prefix):]: v for k, v in datasets.items()
                if k.startswith(prefix)}
    return dict(datasets)


def _layer_weights(all_ds: Datasets, layer: str) -> Datasets:
    """All datasets under a layer name, keyed by their weight kind."""
    out = {}
    for path, arr in all_ds.items():
        parts = path.split("/")
        if layer in parts:
            out[parts[-1].split(":")[0]] = arr  # 'kernel:0' -> 'kernel'
    return out


def params_from_datasets(datasets: Datasets, strict: bool = True
                         ) -> Tuple[Dict[str, np.ndarray], LPCNetModel]:
    """A Keras LPCNet checkpoint's datasets (``read_datasets``) ->
    (params, LPCNetModel).  ``strict=False`` relaxes the upstream-shape
    checks (for re-importing native exports, whose frame net has no pitch
    input and whose bunched GRU-A input is wider)."""
    all_ds = _layers(datasets)

    def layer(name):
        w = _layer_weights(all_ds, name)
        if not w:
            have = sorted(set(p.split("/")[0] for p in all_ds))
            raise ValueError(f"layer '{name}' not found (have: {have})")
        return w

    emb_sig = layer("embed_sig")["embeddings"]
    if emb_sig.shape[0] != MULAW_LEVELS:
        raise ValueError(f"embed_sig has {emb_sig.shape[0]} rows, not "
                         f"{MULAW_LEVELS}")
    embed_dim = emb_sig.shape[1]
    emb_pitch = layer("embed_pitch")["embeddings"]

    conv1 = layer("feature_conv1")
    conv2 = layer("feature_conv2")
    k1, k2 = conv1["kernel"], conv2["kernel"]  # [W, in, out]
    if k1.shape[0] != CONV_WIDTH:
        raise ValueError(f"feature_conv1 kernel {k1.shape}: width "
                         f"{CONV_WIDTH} expected")
    cond_dim = k1.shape[2]
    # An upstream (pitch-conditioned) frame net concatenates the pitch
    # embedding onto the 20 features; a native export reads the features
    # alone (its placeholder pitch table is all zeros).
    uses_pitch = k1.shape[1] == NB_FEATURES + emb_pitch.shape[1]
    if strict and not uses_pitch:
        raise ValueError(
            f"feature_conv1 expects concat(features[{NB_FEATURES}], "
            f"pitch_embed[{emb_pitch.shape[1]}]), got input {k1.shape[1]}")
    d1 = layer("feature_dense1")
    d2 = layer("feature_dense2")

    def gru(name):
        w = layer(name)
        kern, rec, bias = w["kernel"], w["recurrent_kernel"], w["bias"]
        units = rec.shape[0]
        if bias.ndim != 2 or bias.shape[0] != 2:
            raise ValueError(
                f"{name}: expected reset_after GRU bias [2, 3H], got "
                f"{bias.shape}: reset-before GRUs have another candidate "
                f"state and cannot be mapped exactly")
        return {"wx": _reorder_gates(kern, units),
                "wh": _reorder_gates(rec, units),
                "bx": _reorder_gates(bias[0], units),
                "bh": _reorder_gates(bias[1], units), "units": units}

    gru_a, gru_b = gru("gru_a"), gru("gru_b")
    md = layer("dual_fc")
    kern = md["kernel"]  # [in, 256, 2]
    if kern.ndim != 3 or kern.shape[1:] != (MULAW_LEVELS, 2):
        raise ValueError(f"dual_fc kernel shape {kern.shape} != "
                         f"[in, {MULAW_LEVELS}, 2]")
    md_bias, md_factor = md["bias"], md["factor"]  # [256, 2] each

    def f32(a):
        return np.asarray(a, np.float32)

    params = {
        "emb_sig": f32(emb_sig),
        "emb_pred": f32(emb_sig),   # upstream shares ONE table
        "emb_exc": f32(emb_sig),
        "conv1_w": f32(k1.reshape(-1, cond_dim)),
        "conv1_b": f32(conv1["bias"]),
        "conv2_w": f32(k2.reshape(-1, cond_dim)),
        "conv2_b": f32(conv2["bias"]),
        "fc1_w": f32(d1["kernel"]), "fc1_b": f32(d1["bias"]),
        "fc2_w": f32(d2["kernel"]), "fc2_b": f32(d2["bias"]),
        "gru_a_wx": f32(gru_a["wx"]), "gru_a_wh": f32(gru_a["wh"]),
        "gru_a_bx": f32(gru_a["bx"]), "gru_a_bh": f32(gru_a["bh"]),
        "gru_b_wx": f32(gru_b["wx"]), "gru_b_wh": f32(gru_b["wh"]),
        "gru_b_bx": f32(gru_b["bx"]), "gru_b_bh": f32(gru_b["bh"]),
        "fc_out1_w": f32(kern[:, :, 0]), "fc_out2_w": f32(kern[:, :, 1]),
        "fc_out1_b": f32(md_bias[:, 0]), "fc_out2_b": f32(md_bias[:, 1]),
        "fc_out1_g": f32(md_factor[:, 0]), "fc_out2_g": f32(md_factor[:, 1]),
        "fc_out_b": np.zeros(MULAW_LEVELS, np.float32),
        "gru_a_mask": np.ones((gru_a["units"], 3 * gru_a["units"]),
                              np.float32),
    }
    if uses_pitch:
        params["emb_pitch"] = f32(emb_pitch)
    expected_in = 3 * embed_dim + cond_dim
    if strict and params["gru_a_wx"].shape[0] != expected_in:
        raise ValueError(f"gru_a input {params['gru_a_wx'].shape[0]} != "
                         f"3 * embed + cond = {expected_in}")
    model = LPCNetModel(gru_a_units=gru_a["units"],
                        gru_b_units=gru_b["units"], cond_dim=cond_dim,
                        embed_dim=embed_dim)
    logger.info(f"imported LPCNet h5: gru_a={gru_a['units']} "
                f"gru_b={gru_b['units']} cond={cond_dim} embed={embed_dim} "
                f"(shared embed table; the inner-bias head runs the sampler "
                f"kernel)")
    return params, model


def import_lpcnet_h5(path: str, strict: bool = True
                     ) -> Tuple[Dict[str, np.ndarray], LPCNetModel]:
    """Load a Keras LPCNet checkpoint (a full-model or a weights-only save)
    -> (params, LPCNetModel); see ``params_from_datasets``."""
    return params_from_datasets(read_datasets(path), strict)


def datasets_from_params(params) -> Datasets:
    """Params -> the datasets of a weights-only file in the xiph Keras
    layout, keyed by path (``model_weights/<layer>/<layer>/<kind>:0``).

    Native parameters with no upstream slot (per-slot embeddings, the
    outside dual-FC bias, the GRU-A mask, the bunched heads and tables)
    travel under ``dss_tpu_extra/`` for an exact re-import; upstream
    consumers ignore that group (a warning notes the approximation they
    would see)."""
    p = {k: np.asarray(v) for k, v in params.items()}
    per_slot_emb = not (np.array_equal(p["emb_sig"], p["emb_pred"])
                        and np.array_equal(p["emb_sig"], p["emb_exc"]))
    if per_slot_emb or bool(np.any(p["fc_out_b"])):
        logger.warning(
            "datasets_from_params: native checkpoint features (per-slot "
            "embeddings / outside dual-FC bias) have no upstream slot; they "
            f"are stored under {EXTRA} for exact re-import, but third-party "
            "Keras consumers will approximate this model")
    out: Datasets = {}

    def put(layer, kind, arr):
        out[f"{ROOT}/{layer}/{layer}/{kind}:0"] = np.asarray(arr, np.float32)

    put("embed_sig", "embeddings", p["emb_sig"])
    put("embed_pitch", "embeddings",
        p.get("emb_pitch", np.zeros((MULAW_LEVELS, PITCH_EMBED_DIM),
                                    np.float32)))
    cond_dim = p["fc1_w"].shape[0]
    for n in (1, 2):
        w = p[f"conv{n}_w"]
        put(f"feature_conv{n}", "kernel",
            w.reshape(CONV_WIDTH, w.shape[0] // CONV_WIDTH, cond_dim))
        put(f"feature_conv{n}", "bias", p[f"conv{n}_b"])
        put(f"feature_dense{n}", "kernel", p[f"fc{n}_w"])
        put(f"feature_dense{n}", "bias", p[f"fc{n}_b"])
    for name in ("gru_a", "gru_b"):
        units = p[f"{name}_wh"].shape[0]

        put(name, "kernel", _reorder_gates(p[f"{name}_wx"], units))
        put(name, "recurrent_kernel", _reorder_gates(p[f"{name}_wh"], units))
        put(name, "bias", np.stack([_reorder_gates(p[f"{name}_bx"], units),
                                    _reorder_gates(p[f"{name}_bh"], units)]))
    zeros = np.zeros(MULAW_LEVELS, np.float32)
    put("dual_fc", "kernel", np.stack([p["fc_out1_w"], p["fc_out2_w"]], -1))
    put("dual_fc", "bias", np.stack([p.get("fc_out1_b", zeros),
                                     p.get("fc_out2_b", zeros)], -1))
    put("dual_fc", "factor", np.stack([p["fc_out1_g"], p["fc_out2_g"]], -1))
    for key in sorted(p):
        if key in ("emb_pred", "emb_exc", "fc_out_b", "gru_a_mask") \
                or _BUNCHED.search(key):
            out[f"{EXTRA}/{key}"] = np.asarray(p[key], np.float32)
    return out


def export_lpcnet_h5(params, path: str) -> None:
    """Write params into the xiph Keras layout (a weights-only file); exact
    round trip through ``reimport_native_h5``, and through
    ``import_lpcnet_h5`` for upstream-shaped params."""
    h5py = _h5py()
    with h5py.File(path, "w") as f:
        for name, arr in datasets_from_params(params).items():
            f.create_dataset(name, data=arr)


def native_params_from_datasets(datasets: Datasets
                                ) -> Tuple[Dict[str, np.ndarray],
                                           LPCNetModel]:
    """Inverse of ``datasets_from_params`` for native checkpoints: the
    upstream-layout layers plus the ``dss_tpu_extra`` group give back the
    original params exactly."""
    params, _ = params_from_datasets(datasets, strict=False)
    prefix = EXTRA + "/"
    for key, arr in datasets.items():
        if key.startswith(prefix):
            params[key[len(prefix):]] = np.asarray(arr)
    # Native checkpoints use the outside-bias head: exported zero inner
    # biases are placeholders, dropped to restore the native form.
    if "fc_out1_b" in params and not (np.any(params["fc_out1_b"])
                                      or np.any(params["fc_out2_b"])):
        del params["fc_out1_b"]
        del params["fc_out2_b"]
    return params, LPCNetModel.from_params(params)


def reimport_native_h5(path: str) -> Tuple[Dict[str, np.ndarray],
                                           LPCNetModel]:
    """Read an ``export_lpcnet_h5`` file back into the exact params."""
    return native_params_from_datasets(read_datasets(path))

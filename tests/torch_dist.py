"""Several gloo ranks for the port's scale-out tests, on the CPU.

``spawn(fn, world, tmp, *args)`` runs ``fn(rank, *args)`` in ``world``
spawned processes joined by a gloo process group over a ``FileStore`` in
``tmp`` (no TCP port, so parallel test workers cannot collide) and returns
each rank's result, saved with ``torch.save``.  Spawned children import
this module to find ``fn``: it and the workers below import neither jax nor
dss_tpu (tests/conftest.py and the JAX package stay out of the children).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT = 240.0


def _entry(rank, fn, world, tmp, args):
    from dss_tpu_torch.parallel.mesh import init_world

    torch.set_num_threads(1)
    store = dist.FileStore(str(Path(tmp) / "store"), world)
    init_world(torch.device("cpu"), rank, world, store)
    try:
        out = fn(rank, *args)
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp, *args, timeout=SPAWN_TIMEOUT):
    """[fn(0, *args), ..., fn(world - 1, *args)], each run in its own
    process; raises if a rank fails or the ranks outlast ``timeout``."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(fn, world, str(tmp), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks outlasted {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# -- tests/test_torch_parallel.py ---------------------------------------------
def parallel_cases(rank, inputs):
    """Every world-4 (2 x 2) case of tests/test_torch_parallel.py on one
    rank: its mesh coordinates and each case's local results."""
    from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel
    from dss_tpu_torch.parallel import make_mesh, shard_lstm_params, \
        sharded_decoder_train_step, sharded_fused_word_path, \
        sharded_vad_train_step, sharded_vocoder_train_step
    from dss_tpu_torch.parallel.shard import decoder_trainer, vad_trainer
    from dss_tpu_torch.train.trainer_vocoder import VocoderTrainer
    from dss_tpu_torch.vocoder import net as tnet

    inp = dict(np.load(inputs, allow_pickle=True))
    mesh = make_mesh(4, device="cpu")
    out = dict(shape=mesh.shape, data=mesh.get_local_rank("data"),
               model=mesh.get_local_rank("model"))

    # Gate blocks at the deployed decoder's width.
    model = BidirectionalSpeechSynthesisModel(2, 100, 64)
    sharded = shard_lstm_params(mesh, model, 100)
    out["shard_shapes"] = {k: tuple(v.shape)
                           for k, v in sharded.state_dict().items()}

    # The gate-parallel forward on the JAX decoder's parameters.
    dec_sd = {k[4:]: torch.as_tensor(v) for k, v in inp.items()
              if k.startswith("dec.")}
    E, H = inp["fwd_x"].shape[-1], int(inp["hidden"])
    dec = BidirectionalSpeechSynthesisModel(2, H, E, nb_outputs=4)
    dec.load_state_dict(dec_sd)
    sharded = shard_lstm_params(mesh, dec, H)
    rows = slice(out["data"] * 4, out["data"] * 4 + 4)
    with torch.no_grad():
        out["forward"] = sharded(torch.as_tensor(inp["fwd_x"][rows]),
                                 lengths=inp["fwd_len"][rows])[0].numpy()

    # Data x gate-parallel decoder and nVAD steps, unequal valid counts.
    tr = decoder_trainer(mesh, E, H)
    out["dec_loss"] = float(sharded_decoder_train_step(
        mesh, inp["dec_x"], inp["dec_y"], inp["dec_mask"], H, trainer=tr))
    out["dec_grads"] = {k: p.grad.numpy().copy()
                        for k, p in tr.model.named_parameters()}
    tr = vad_trainer(mesh, E, H)
    out["vad_loss"] = float(sharded_vad_train_step(
        mesh, inp["vad_x"], inp["vad_y"], inp["vad_mask"], H, trainer=tr))
    out["vad_grads"] = {k: p.grad.numpy().copy()
                        for k, p in tr.model.named_parameters()}

    # The data-parallel vocoder step: the gradient it applies.
    vt = VocoderTrainer(tnet.LPCNetModel(), learning_rate=1e-3,
                        noise_level=0, device="cpu")
    vt.init()
    applied = {}
    apply = vt._apply
    vt._apply = lambda g: applied.update(g) or apply(g)
    out["voc_loss"] = float(sharded_vocoder_train_step(
        mesh, vt, inp["voc_feats"], inp["voc_sig"]))
    out["voc_grad_gru_a_wh"] = applied["gru_a_wh"].numpy().copy()

    # The sharded word path on the JAX decoder and vocoder parameters.
    wp_dec = BidirectionalSpeechSynthesisModel(2, H, inp["seg"].shape[-1])
    voc = {k[4:]: torch.as_tensor(v) for k, v in inp.items()
           if k.startswith("voc.")}
    voc_model = tnet.LPCNetModel.from_params(voc)
    lpc, pcm = sharded_fused_word_path(
        mesh, inp["seg"], inp["seg_mask"], wp_dec,
        {k[3:]: torch.as_tensor(v) for k, v in inp.items()
         if k.startswith("wp.")},
        voc_model, voc, tnet.net_vocoder_init(voc_model, 8, device="cpu"))
    out["word_lpc"], out["word_pcm"] = lpc, pcm
    return out


# -- tests/test_torch_sharded_serving.py --------------------------------------
SERVE_E = 8  # electrodes of the serving tests' decoder


def serve_segments(seed, lengths):
    """Seeded decoder inputs [T, SERVE_E], one a length."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(T, SERVE_E)).astype(np.float32)
            for T in lengths]


class SlotFeeder:
    """A ``slot_feeder`` that hands out fixed segments (picklable)."""

    def __init__(self, segments):
        self.segments = segments

    def __call__(self, n, live_frames):
        return self.segments


def serve_unit(voc_w, feeder, chunked, streams=8, length_multiple=50):
    """The serving tests' ShardedFusedDecoderVocoder on the CPU: a 1 x 16
    decoder seeded with 0, ``voc_w``'s vocoder, on every rank."""
    from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel
    from dss_tpu_torch.runtime.units import ShardedFusedDecoderVocoder, \
        ShardedFusedDecoderVocoderSettings

    u = ShardedFusedDecoderVocoder()
    u.apply_settings(ShardedFusedDecoderVocoderSettings(
        path_to_model_weights=None,
        model=BidirectionalSpeechSynthesisModel,
        params=dict(nb_layer=1, nb_hidden_units=16, nb_electrodes=SERVE_E),
        vocoder_weights=voc_w, length_multiple=length_multiple,
        prewarm_frames=(),
        streams=streams, slot_feeder=feeder,
        chunk_emission=chunked, device="cpu"))
    u.initialize()
    return u


def run_word(unit, live):
    """One word through the unit's head and every tail chunk -> (slot 0's
    features, slot 0's audio, {slot: audio} of the others)."""
    lpc, a0, n_chunks, word = unit._head(live)
    parts = [a0] + [unit._tail(word, k) for k in range(1, n_chunks)]
    return lpc, np.concatenate(parts), unit.slot_audio


def serve_world(rank, voc_w, lengths):
    """The sharded unit on one rank of a gloo world: a chunked unit, then a
    single-shot one, each serving one word of 8 distinct slots; rank 0
    returns what they published, the other ranks serve as workers."""
    live, *bg = serve_segments(3, lengths)
    out = {}
    for chunked in (True, False):
        unit = serve_unit(voc_w, SlotFeeder(bg), chunked)
        out[f"slots_{chunked}"] = (unit._slots.start, unit._slots.stop)
        if rank == 0:
            out["chunked" if chunked else "single"] = run_word(unit, live)
        else:
            unit.run_worker()
        unit.shutdown()
    return out


# -- tests/test_torch_graft_entry.py ------------------------------------------
def graft_dryrun(rank, n):
    """``graft_entry.dryrun_multichip(n)`` on one rank of a gloo world."""
    from dss_tpu_torch.graft_entry import dryrun_multichip
    return dryrun_multichip(n, device="cpu")

"""Entry points on the port (counterpart of __graft_entry__.py): the
flagship decoder's forward step, and a dry run of the multi-device paths.

``entry()`` returns ``(forward, (model, example_segment))``: the forward
step of the bidirectional speech-decoding model (2 x 100, 64 electrodes,
seeded) over one completed speech segment [1, 100, 64], as the online
decoding unit calls it.

``dryrun_multichip(n)`` runs the seven steps of the JAX dry run over the
current process group's ``n`` ranks (``parallel/``: a ("data", "model")
mesh on NCCL or gloo), at the JAX dry run's tiny widths and with its
asserts: the data x gate-parallel decoder step, the nVAD TBPTT step, the
data-parallel vocoder step, batched vocoder serving at bunch 2 (the
sampler kernel K3 on the card), ``sharded_fused_word_path``,
``ShardedFusedDecoderVocoder._decode_and_vocode`` and distinct-slot
chunked serving.  In the two unit steps the unit serves one slot a rank
(the JAX unit one a data coordinate): rank 0 serves and every other rank
runs the unit's worker loop::

    python -m dss_tpu_torch.graft_entry [--device cpu]     # world 1
    torchrun --nproc-per-node N -m dss_tpu_torch.graft_entry

Alone it starts a world of one (NCCL on the card, gloo with ``--device
cpu``; no fallback between them); under torchrun it joins the world it is
given.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .device import resolve_device
from .models.decoder import BidirectionalSpeechSynthesisModel
from .models.lstm import seeded_init


def entry(device=None):
    """(forward, (model, example_segment)): the flagship decoder's forward
    step and its example arguments, on ``device`` (default cuda)."""
    dev = resolve_device(device)
    model = BidirectionalSpeechSynthesisModel(
        nb_layer=2, nb_hidden_units=100, nb_electrodes=64)
    seeded_init(model, 0)
    model = model.to(dev).eval()

    @torch.no_grad()
    def forward(model, segment):
        # One completed speech segment [B, T, 64] -> LPC features [B, T, 20];
        # fresh zero state per segment, like the online decoding unit.
        pred, _ = model(segment)
        return pred

    example_segment = torch.zeros((1, 100, 64), device=dev)
    return forward, (model, example_segment)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The seven steps over a mesh of ``n_devices`` ranks (the current
    process group, or a world of one started here); every rank calls it.
    Returns the losses and shapes that rank 0 checked."""
    from .parallel import (batched_vocoder_sharding, make_mesh,
                           sharded_decoder_train_step, sharded_fused_word_path,
                           sharded_vad_train_step, sharded_vocoder_train_step)
    from .parallel.mesh import axis, mesh_device
    from .parallel.shard import _gather_rows
    from .runtime.units import ShardedFusedDecoderVocoder, \
        ShardedFusedDecoderVocoderSettings
    from .train.trainer_vocoder import VocoderTrainer
    from .vocoder.net import LPCNetModel, net_synthesize_frames, \
        net_vocoder_init

    mesh = make_mesh(n_devices, device=device)
    dev = mesh_device(mesh)
    lead = dist.get_rank() == 0
    tag = f"dryrun_multichip({n_devices})"

    def say(text):
        if lead:
            print(f"{tag}: {text}", flush=True)

    out = {"mesh": tuple(mesh.shape)}
    rng = np.random.default_rng(0)
    n_streams = axis(mesh, "data")[0]
    B, T, E, F = n_streams * 2, 50, 64, 20
    x = rng.normal(size=(B, T, E)).astype(np.float32)
    y = rng.normal(size=(B, T, F)).astype(np.float32)
    mask = np.ones((B, T), np.float32)

    # 1/7: decoder train step, data-parallel over trials x gate-parallel.
    loss = float(sharded_decoder_train_step(mesh, x, y, mask))
    assert np.isfinite(loss), "non-finite decoder loss"
    out["decoder_loss"] = loss
    say(f"decoder train step ok, loss={loss:.4f}")

    # 2/7: nVAD TBPTT trial on the same layout.
    labels = (rng.random((B, T)) > 0.5).astype(np.float32)
    vad_loss = float(sharded_vad_train_step(mesh, x, labels, mask,
                                            hidden=32))
    assert np.isfinite(vad_loss), "non-finite VAD loss"
    out["vad_loss"] = vad_loss
    say(f"vad tbptt step ok, loss={vad_loss:.4f}")

    # 3/7: data-parallel vocoder step (replicated parameters, each rank's
    # rows of the utterance-chunk batch, the gradient averaged).
    voc_model = LPCNetModel(gru_a_units=16, gru_b_units=8, cond_dim=8,
                            embed_dim=8)
    trainer = VocoderTrainer(voc_model, device=dev)
    trainer.init()
    feats = (rng.normal(size=(n_streams, 4, 20)) * 0.1).astype(np.float32)
    sig = (rng.normal(size=(n_streams, 4 * 160)) * 0.1).astype(np.float32)
    vloss = float(sharded_vocoder_train_step(mesh, trainer, feats, sig))
    assert np.isfinite(vloss), "non-finite vocoder loss"
    out["vocoder_loss"] = vloss
    say(f"dp vocoder train step ok, loss={vloss:.4f}")

    # 4/7: batched vocoder serving at bunch 2, the stream state and the
    # features split over the data axis, the audio gathered.
    serve_model = LPCNetModel(gru_a_units=16, gru_b_units=8, cond_dim=8,
                              embed_dim=8, bunch=2)
    sparams = serve_model.init(torch.Generator().manual_seed(2), dev)
    sfeats = (rng.normal(size=(n_streams, 2, 20)) * 0.1).astype(np.float32)
    sstate, sfeats_d = batched_vocoder_sharding(
        mesh, net_vocoder_init(serve_model, batch=n_streams, device=dev),
        sfeats)
    pcm, _ = net_synthesize_frames(serve_model, sparams, sstate, sfeats_d)
    pcm = _gather_rows(mesh, pcm).cpu().numpy()
    assert pcm.shape == (n_streams, 2 * 160)
    assert np.isfinite(pcm).all() and np.abs(pcm).max() <= 1.0
    out["serving_pcm_shape"] = pcm.shape
    say(f"sharded vocoder serving ok, {n_streams} streams")

    # 5/7: the fused word path (decode, hold the last valid frame over the
    # padding, vocode) sharded over streams.
    word_decoder = BidirectionalSpeechSynthesisModel(
        nb_layer=2, nb_hidden_units=8, nb_electrodes=E)
    seeded_init(word_decoder, 3)
    Tw = 4
    wsegs = (rng.normal(size=(n_streams, Tw, E)) * 0.1).astype(np.float32)
    wmask = np.ones((n_streams, Tw), np.float32)
    wmask[:, -1] = 0.0  # one padded frame per word (exercises the hold)
    lpc, pcm = sharded_fused_word_path(
        mesh, wsegs, wmask, word_decoder, None, serve_model, sparams,
        net_vocoder_init(serve_model, batch=n_streams, device=dev))
    assert lpc.shape == (n_streams, Tw, 20)
    assert pcm.shape == (n_streams, Tw * 160)
    assert np.isfinite(pcm).all() and np.abs(pcm).max() <= 1.0
    out["word_path_shapes"] = (lpc.shape, pcm.shape)
    say(f"fused word path ok, {n_streams} words")

    # The serving unit shards its slots over every rank of the group (the
    # JAX unit over the mesh's data axis): one slot a rank.
    slots = dist.get_world_size()

    def unit(**kw):
        u = ShardedFusedDecoderVocoder()
        u.apply_settings(ShardedFusedDecoderVocoderSettings(
            path_to_model_weights=None,
            model=BidirectionalSpeechSynthesisModel,
            params=dict(nb_layer=1, nb_hidden_units=8, nb_electrodes=E),
            prewarm_frames=(), n_devices=n_devices, streams=slots,
            device=str(dev.type), **kw))
        u.initialize()
        return u

    # 6/7: the serving unit around the word program, driven as the graph
    # drives it (rank 0), the other ranks as its workers.
    u6 = unit(vocoder_weights=None, length_multiple=4)
    seg6 = (rng.normal(size=(3, E)) * 0.1).astype(np.float32)
    if lead:
        g_lpc, g_audio = u6._decode_and_vocode(seg6)
        assert g_lpc.shape == (3, 20) and g_audio.shape == (3 * 160,)
        assert g_audio.dtype == np.int16
        out["graph_shapes"] = (g_lpc.shape, g_audio.shape)
    else:
        u6.run_worker()
    u6.shutdown()
    say(f"graph serving ok, {slots}-stream sharded word unit")

    # 7/7: distinct per-slot segments and chunked emission: every slot its
    # own length, the word as a head chunk and one tail chunk (Tp = 100).
    bg = [(rng.normal(size=(t, E)) * 0.1).astype(np.float32)
          for t in (30, 80, 55, 42, 100, 67, 25)][: slots - 1]
    with tempfile.TemporaryDirectory() as tmp:
        tiny_voc = os.path.join(tmp, "tiny_voc.npz")
        np.savez(tiny_voc, **{k: v.cpu().numpy() for k, v in
                              serve_model.init(torch.Generator()
                                               .manual_seed(7), "cpu")
                              .items()})
        u7 = unit(vocoder_weights=tiny_voc, length_multiple=50,
                  slot_feeder=lambda n, t: bg[:n])
    assert u7._chunked
    live = (rng.normal(size=(60, E)) * 0.1).astype(np.float32)
    if lead:
        d_lpc, d_audio0, d_pending, d_Ts = u7._decode_head(live)
        for k, b in enumerate(d_pending, start=1):
            u7._read_chunk(b, k, d_Ts)
        assert d_lpc.shape == (60, 20) and len(d_audio0) == 50 * 160
        assert len(d_pending) == 1  # Tp = 100: head chunk + one tail chunk
        bg_audio = {i: np.concatenate(p) for i, p in u7._bg_parts.items()}
        assert len(bg_audio) == slots - 1
        assert all(len(bg_audio[i + 1]) == len(bg[i]) * 160
                   for i in range(slots - 1))
        out["chunked"] = dict(head=len(d_audio0), tails=len(d_pending),
                              slots=slots)
    else:
        u7.run_worker()
    u7.shutdown()
    say(f"distinct-slot chunked serving ok, {slots} independent streams")
    say(f"ok, loss={loss:.4f}")
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="Torch device (default: cuda).")
    args = parser.parse_args(argv)
    forward, (model, segment) = entry(args.device)
    pred = forward(model, segment)
    print("entry forward:", tuple(pred.shape))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    try:
        return dryrun_multichip(world, device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""Train the neural vocoder on a directory of 16 kHz wav files (counterpart
of apps/train_vocoder.py).

Teacher-forced mu-law excitation cross-entropy, then optionally scheduled
sampling (``--sampled-noise-after``) and the free-running STFT fine-tune
(``--freerun-after``), with progressive GRU-A pruning in the sampler
kernel's [16 x 128] tiles; ``vocoder.npz`` every epoch (loads in
``LPCNet(backend="net", weights=...)`` of both packages), the
best-by-validation ``vocoder_best.npz`` under ``--val-wav``, and the
training state after every epoch (``train_state.pth``, resumed with
``--resume``).  On the device the command line names (default cuda).

    python -m dss_tpu_torch.apps.train_vocoder WAV_DIR OUT_DIR
        [--epochs 10] [--batch 32] [--chunk-frames 15] [--bunch 1]
        [--sampled-noise-after N] [--freerun-after N] [--val-wav PATH]
        [--init-weights NPZ] [--resume] [--device cpu]
"""

import argparse
import logging
import os
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..device import resolve_device
from ..train.checkpoints import load_train_state, save_train_state, \
    save_vocoder_params
from ..train.trainer_vocoder import VocoderTrainer, prepare_utterance
from ..utils.audio import read_wav
from ..vocoder.net import LPCNetModel

logger = logging.getLogger("train_vocoder.py")


def load_corpus(wav_dir: Path, chunk_frames: int, device=None):
    """Slice every wav into fixed-length (features, signal) windows."""
    feats_all, sigs_all = [], []
    for wav_path in sorted(wav_dir.rglob("*.wav")):
        fs, audio = read_wav(str(wav_path))
        if fs != 16000:
            logger.warning(f"Skipping {wav_path} (fs={fs}, need 16 kHz)")
            continue
        if audio.ndim > 1:
            audio = audio[:, 0]
        feats, sig = prepare_utterance(audio, device)
        n_chunks = len(feats) // chunk_frames
        for c in range(n_chunks):
            feats_all.append(feats[c * chunk_frames:(c + 1) * chunk_frames])
            s0 = c * chunk_frames * 160
            sigs_all.append(sig[s0:s0 + chunk_frames * 160])
    if not feats_all:
        raise SystemExit(f"No usable 16 kHz wavs under {wav_dir}")
    return np.stack(feats_all), np.stack(sigs_all)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train the neural vocoder.")
    parser.add_argument("wav_dir", help="Directory of 16 kHz mono wavs.")
    parser.add_argument("out_dir", help="Training output directory.")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--chunk-frames", type=int, default=15,
                        help="Training window length in 10 ms frames.")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--lr-decay", type=float, default=0.0,
                        help="Per-step hyperbolic LR decay "
                             "(lr_t = lr / (1 + decay * t)). 0 = constant.")
    parser.add_argument("--noise-level", type=int, default=2,
                        help="mu-law-domain jitter (+-levels) injected into "
                             "the teacher-forced signal history.")
    parser.add_argument("--sampled-noise-after", type=int, default=None,
                        help="From this epoch on, drift the teacher-forced "
                             "history with the model's own sampled "
                             "excitations (scheduled sampling, bunch=1 "
                             "only).")
    parser.add_argument("--freerun-after", type=int, default=None,
                        help="From this epoch on, train on the free-running "
                             "rollout (STFT loss + teacher-forced CE "
                             "anchor); takes precedence over "
                             "--sampled-noise-after.")
    parser.add_argument("--stft-weight", type=float, default=2.0,
                        help="Weight of the STFT term in --freerun-after "
                             "epochs, relative to the CE anchor.")
    parser.add_argument("--grad-clip", type=float, default=0.0,
                        help="Global-norm gradient clip (0 = off); ~1.0 "
                             "with --freerun-after.")
    parser.add_argument("--rollout-detach", type=int, default=0,
                        help="Truncate free-running rollout backprop every "
                             "N samples (0 = full length).")
    parser.add_argument("--density", type=float, default=0.2,
                        help="Final GRU-A recurrent density after pruning.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bunch", type=int, default=1,
                        help="Samples per sample-rate-network step; baked "
                             "into the checkpoint.")
    parser.add_argument("--val-wav", default=None,
                        help="Held-out 16 kHz wav OR a directory of wavs: "
                             "every --score-every epochs, score a "
                             "free-running encode->synthesize round trip "
                             "(mean Bark-cepstral distortion over the wavs) "
                             "and keep the best as vocoder_best.npz.")
    parser.add_argument("--val-max-wavs", type=int, default=6,
                        help="Cap on wavs scored per round when --val-wav "
                             "is a directory.")
    parser.add_argument("--score-every", type=int, default=10,
                        help="Epoch interval for --val-wav scoring.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from OUT_DIR/train_state.pth (params "
                             "+ optimizer state + epoch counter).")
    parser.add_argument("--device", default="cuda",
                        help="Torch device (cuda unless given; no silent "
                             "CPU fallback).")
    parser.add_argument("--init-weights", default=None,
                        help="Initialize params from a checkpoint .npz "
                             "(fresh optimizer state, epoch 0); the "
                             "architecture, bunch and mask come from the "
                             "file.")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Run the training the command line describes; returns each epoch's
    mean loss.  The epoch log goes to OUT_DIR/training.log."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    handler = logging.FileHandler(os.path.join(args.out_dir, "training.log"),
                                  "w+")
    handler.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(name)-30s] [%(levelname)8s]: %(message)s",
        datefmt="%d.%m.%y %H:%M:%S"))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        return _train(args, device)
    finally:
        logger.removeHandler(handler)
        handler.close()


def _train(args: argparse.Namespace, device) -> List[float]:
    from ..eval.quality import score_roundtrip
    from ..vocoder.lpcnet import LPCNet

    feats, sigs = load_corpus(Path(args.wav_dir), args.chunk_frames, device)
    logger.info(f"Corpus: {len(feats)} chunks of {args.chunk_frames} frames")

    init_params = None
    inherited_density = None
    ramp_start_density = 1.0
    if args.init_weights:
        with np.load(args.init_weights) as f:
            init_params = {k: f[k] for k in f.files}
        model = LPCNetModel.from_params(init_params)
        logger.info(f"Initialized params from {args.init_weights} "
                    f"(bunch={model.bunch})")
        if "gru_a_mask" in init_params:
            mask_density = float(init_params["gru_a_mask"].mean())
            if mask_density <= args.density + 1e-3:
                # Already pruned to (or below) the target: keep its mask
                # fixed; re-sparsifying at mid-ramp densities would let
                # zeroed tiles regrow.
                inherited_density = mask_density
                logger.info(
                    f"Checkpoint mask density {mask_density:.3f} <= target "
                    f"{args.density}: pruning disabled, mask inherited")
            elif mask_density < 1.0 - 1e-3:
                # Partially pruned: ramp from ITS density down to the
                # target, never above.
                ramp_start_density = mask_density
                logger.info(
                    f"Checkpoint mask density {mask_density:.3f} > target "
                    f"{args.density}: prune ramp starts at the checkpoint "
                    f"density")
    else:
        model = LPCNetModel(bunch=args.bunch)
    trainer = VocoderTrainer(model, learning_rate=args.lr,
                             noise_level=args.noise_level,
                             lr_decay=args.lr_decay,
                             stft_weight=args.stft_weight,
                             grad_clip=args.grad_clip,
                             rollout_detach=args.rollout_detach,
                             device=device, seed=args.seed)
    params = trainer.init(init_params)

    state_path = os.path.join(args.out_dir, "train_state.pth")
    start_epoch = 0
    resumed_best = float("inf")
    if args.resume and os.path.exists(state_path):
        extra = load_train_state(state_path, params, trainer.optimizer,
                                 trainer.scheduler)
        start_epoch = int(extra.get("epoch", 0))
        resumed_best = float(extra.get("best_score", float("inf")))
        logger.info(f"Resumed from {state_path} at epoch {start_epoch} "
                    f"(best val score so far: {resumed_best:.2f} dB)")

    rng = np.random.default_rng(args.seed)
    steps_per_epoch = max(1, len(feats) // args.batch)
    # Pruning ramps from 25% to 80% of the run: the final 20% of epochs
    # train AT target density (recovery window).
    prune_start = args.epochs // 4
    prune_end = max(prune_start + 1, (args.epochs * 4) // 5)
    # Carried across --resume so a resumed run cannot overwrite
    # vocoder_best.npz with a worse checkpoint.
    best_score = resumed_best
    history = []
    for epoch in range(start_epoch, args.epochs):
        order = rng.permutation(len(feats))
        losses = []
        for s in range(steps_per_epoch):
            idx = order[s * args.batch:(s + 1) * args.batch]
            if len(idx) < args.batch:
                break
            if (args.freerun_after is not None
                    and epoch >= args.freerun_after):
                step_fn = trainer.train_step_freerun
            elif (args.sampled_noise_after is not None
                    and epoch >= args.sampled_noise_after
                    and model.bunch == 1):
                step_fn = trainer.train_step_sampled
            else:
                step_fn = trainer.train_step
            losses.append(float(step_fn(feats[idx], sigs[idx])))

        # Progressive sparsification from 100% down to the target density
        # (skipped when --init-weights supplied an already-pruned mask).
        if inherited_density is not None:
            density = inherited_density
        elif epoch >= prune_start and args.density < 1.0:
            progress = min(1.0, (epoch - prune_start + 1)
                           / max(1, prune_end - prune_start))
            density = ramp_start_density \
                - (ramp_start_density - args.density) * progress
            trainer.sparsify(params, density)
        else:
            # Pre-ramp epochs still carry the checkpoint's mask, so gate
            # best-by-validation on ITS density.
            density = ramp_start_density

        history.append(float(np.mean(losses)))
        logger.info(f"Epoch {epoch + 1:>03}: CE loss {history[-1]:.4f} "
                    f"(GRU-A density {density:.2f})")
        save_vocoder_params(os.path.join(args.out_dir, "vocoder.npz"), params)

        if args.val_wav and (epoch + 1) % max(1, args.score_every) == 0:
            if os.path.isdir(args.val_wav):
                val_paths = sorted(
                    str(p) for p in Path(args.val_wav).glob("*.wav")
                )[: max(1, args.val_max_wavs)]
            else:
                val_paths = [args.val_wav]
            dists, snrs = [], []
            for vp in val_paths:
                fs, val_audio = read_wav(vp)
                # A fresh detached copy each time: the sampler caches its
                # tile layout with the weights it is given.
                vocoder = LPCNet(backend="net", model=model,
                                 weights={k: v.detach().cpu().numpy()
                                          for k, v in params.items()},
                                 device=device)
                r = score_roundtrip(val_audio[: 16000 * 2], vocoder,
                                    device=device)
                dists.append(r.cepstral_distance_db)
                snrs.append(r.band_level_snr_db)
            cd, snr = float(np.mean(dists)), float(np.mean(snrs))
            logger.info(
                f"Epoch {epoch + 1:>03}: free-running val distortion "
                f"{cd:.2f} dB mean over {len(val_paths)} wav(s) "
                f"(band SNR {snr:.2f} dB)")
            # Best-by-VALIDATION checkpoint; epochs within 1.5x of the target
            # density qualify (a slightly denser tile mask still runs the
            # sparse path).
            if cd < best_score and density <= args.density * 1.5 + 1e-6:
                best_score = cd
                save_vocoder_params(
                    os.path.join(args.out_dir, "vocoder_best.npz"), params)
                logger.info(f"Epoch {epoch + 1:>03}: new best val score — "
                            f"saved vocoder_best.npz")

        # Saved after validation so a resume sees the epoch's best_score.
        save_train_state(state_path, params, trainer.optimizer,
                         extra={"epoch": epoch + 1, "best_score": best_score},
                         scheduler=trainer.scheduler)

    logger.info(f"Saved weights to {os.path.join(args.out_dir, 'vocoder.npz')}")
    if best_score < float("inf"):
        logger.info(f"Best-by-validation checkpoint: vocoder_best.npz "
                    f"({best_score:.2f} dB)")
    return history


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(name)-30s] [%(levelname)8s]: %(message)s",
        datefmt="%d.%m.%y %H:%M:%S", handlers=[logging.StreamHandler(sys.stderr)])
    main()

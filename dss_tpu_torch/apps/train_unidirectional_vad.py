"""Train the unidirectional neural VAD model (counterpart of
apps/train_unidirectional_vad.py).

Leave-one-day-out with fixed test and validation days, TBPTT k1 = k2 = 50,
RMSprop lr = 1e-4, cross-entropy, dropout 0.5, per-epoch validation
accuracy and prediction plots, the best checkpoint by accuracy
(``best_model.pth``), the training state after every epoch
(``train_state.pth``, resumed with ``--resume``).  On the device the
command line names (default cuda).

    python -m dss_tpu_torch.apps.train_unidirectional_vad CORPUS OUT
        [--epochs 8] [--batch_size 1] [--resume] [--device cpu]
"""

import argparse
import logging
import os
import sys
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

from ..device import resolve_device
from ..models.lstm import seeded_init
from ..models.vad import UnidirectionalVoiceActivityDetector
from ..ops.ringbuffer import VoiceActivityDetectionSmoothing
from ..train.checkpoints import StoreBestModel, load_train_state, \
    save_train_state
from ..train.dataset import Recordings, corpus_files, datasets, \
    padded_batches
from ..train.trainer_vad import VadTrainer
from ..utils.channels import SelectElectrodesOverSpeechAreas
from ..utils.cv import LeaveOneDayOut

logger = logging.getLogger("train_unidirectional_vad.py")


@dataclass
class TrainingConfiguration:
    nb_hidden_units: int
    nb_layer: int
    nb_epochs: int
    batch_size: int
    num_workers: int
    truncated_sequence_length: int
    speech_corpus_root: Path
    out_dir: Path
    test_day: str
    valid_day: str
    seed: int = 0
    resume: bool = False
    device: str = "cuda"


def visualize_vad_predictions(pred, orig, speech_probs, filename: Path):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    smoothing = VoiceActivityDetectionSmoothing(nb_features=64, context_frames=5)
    _, smoothed = smoothing.insert(data=np.zeros((len(pred), 64)),
                                   speech_labels=pred)

    fig, ax = plt.subplots(1, 1, num=1, clear=True)
    ax.plot(orig, c="black", linestyle="--")
    ax.plot(smoothed, c="orange")
    ax.plot(speech_probs, c="blue")
    ax.axhline(0.5, c="gray", alpha=0.5)
    ax.set_xlim(0, len(speech_probs))
    ax.set_xlabel("Time [seconds]")
    ax.set_ylabel("Probability")
    ax.set_xticks([0, 100])
    ax.set_xticklabels([0, 1])
    acc = list(pred == orig).count(True) / len(pred) * 100
    ax.set_title(f"Trial accuracy: {acc:.2f}")
    plt.savefig(filename.as_posix(), dpi=72)
    plt.close(fig)


def split_days(feature_files, test_day, valid_day):
    groups_by_day = defaultdict(list)
    for feature_file in feature_files:
        groups_by_day[feature_file.parent.name].append(feature_file)

    train_days, test = next(LeaveOneDayOut().split(
        X=groups_by_day.keys(), start_with_day=test_day))
    train_days, val = next(LeaveOneDayOut().split(
        train_days, start_with_day=valid_day))

    tr = [f.as_posix() for f in feature_files if f.parent.name in train_days]
    va = [f.as_posix() for f in feature_files if f.parent.name == val]
    tr = [f for f in tr if f not in va]
    te = sorted(f.as_posix() for f in feature_files if f.parent.name == test)
    return tr, va, te, test, val


def main(cfg: TrainingConfiguration, recordings: Recordings = None
         ) -> List[dict]:
    """Train on the ``.hdf`` corpus under ``cfg.speech_corpus_root``, or on
    ``recordings`` ({file name: recording}, as corpus preparation's
    ``prepare`` returns them) when given.  Returns each epoch's mean train
    loss, validation loss and accuracy."""
    device = resolve_device(cfg.device)
    try:
        from torch.utils.tensorboard import SummaryWriter

        summary_writer = SummaryWriter(
            log_dir=os.path.join(cfg.out_dir, "tensorboard"))
    except ImportError:
        summary_writer = None

    best_model = StoreBestModel(
        filename=os.path.join(cfg.out_dir, "best_model.pth"),
        head_name="classifier",
    )

    feature_files = corpus_files(cfg.speech_corpus_root, "*.hdf", recordings)
    os.makedirs(os.path.join(cfg.out_dir, "valid_viz"), exist_ok=True)

    tr_files, va_files, _, test_day, val_day = split_days(
        feature_files, cfg.test_day, cfg.valid_day)
    logger.info(
        f"Starting Leave-one-day-out cross validation with {test_day} as "
        f"test and {val_day} as validation day."
    )

    selection = SelectElectrodesOverSpeechAreas()
    tr_dataset, va_dataset = datasets(
        [tr_files, va_files], recordings, transform=selection,
        target_specifier="vad_labels")
    logger.info(repr(tr_dataset))

    model = seeded_init(UnidirectionalVoiceActivityDetector(
        nb_layer=cfg.nb_layer, nb_hidden_units=cfg.nb_hidden_units,
        nb_electrodes=len(selection), dropout=0.5,
    ), cfg.seed)
    trainer = VadTrainer(model, learning_rate=1e-4,
                         chunk=cfg.truncated_sequence_length, device=device)
    start_epoch = 0
    resume_path = os.path.join(cfg.out_dir, "train_state.pth")
    if cfg.resume and os.path.exists(resume_path):
        extra = load_train_state(resume_path, trainer.model, trainer.optimizer)
        start_epoch = int(extra.get("epoch", 0))
        logger.info(f"Resumed training state from epoch {start_epoch}.")

    n_params = sum(p.numel() for p in trainer.model.parameters())
    logger.info(
        f"Total number of trainable parameters of the "
        f"{type(model).__name__} model: {n_params:,}"
    )

    update_steps_counter = 0
    history = []
    rng = np.random.default_rng(cfg.seed)
    for epoch in range(start_epoch, cfg.nb_epochs):
        if cfg.batch_size > 1:
            batches = padded_batches(
                tr_dataset, cfg.batch_size, rng=rng,
                length_multiple=cfg.truncated_sequence_length)
        else:
            batches = (trainer.pad_trial(*tr_dataset[int(idx)])
                       for idx in rng.permutation(len(tr_dataset)))
        train_loss = []
        for xp, yp, m in batches:
            train_loss.append(float(trainer.tbptt_trial(xp, yp, m)))
            update_steps_counter += \
                xp.shape[1] // cfg.truncated_sequence_length

        valid_loss = 0.0
        correct = 0.0
        total = 0.0
        for val_index in range(len(va_dataset)):
            x, y = va_dataset[val_index]
            xp, yp, m = trainer.pad_trial(x, y)
            loss, c, t, probs = trainer.evaluate(xp, yp, m)
            valid_loss += float(loss)
            correct += float(c)
            total += float(t)

            T = len(x)
            probs = probs.cpu().numpy()[0, :T]
            pred = (probs > 0.5).astype(np.int64)
            orig = np.asarray(y).reshape(-1)[:T].astype(np.int64)
            plot = Path(os.path.join(cfg.out_dir, "valid_viz",
                                     f"epoch={epoch + 1:03d}",
                                     f"trial_id={val_index:03d}.png"))
            os.makedirs(plot.parent.as_posix(), exist_ok=True)
            visualize_vad_predictions(pred, orig, probs, plot)

        val_score = correct / max(total, 1)
        mean_train = sum(train_loss) / max(len(train_loss), 1)
        history.append(dict(epoch=epoch + 1, train_loss=mean_train,
                            valid_loss=valid_loss, valid_acc=val_score))
        logger.info(
            f"Epoch {epoch + 1:>04}: Train loss: {mean_train:.04f} -- "
            f"Validation loss: {valid_loss:.04f} ({update_steps_counter:>6} "
            f"update steps) [Validation Accuracy: {val_score * 100:.02f}]"
        )
        if summary_writer is not None:
            summary_writer.add_scalars(
                "Training vs. validation loss",
                {"Train": mean_train, "Valid": valid_loss}, epoch + 1)
            summary_writer.add_scalar("Validation accuracy", val_score,
                                      epoch + 1)
        best_model.update(trainer.model, validation_acc=val_score,
                          info={"update_steps": update_steps_counter,
                                "epoch": epoch + 1})
        save_train_state(resume_path, trainer.model, trainer.optimizer,
                         extra={"epoch": epoch + 1})

    if best_model.optional_info is not None:
        logger.info(
            f"Training finished. Best validation accuracy obtained after "
            f"{best_model.optional_info['update_steps']} update steps "
            f"[epoch {best_model.optional_info['epoch']}]."
        )
    return history


def parse_config(argv=None) -> TrainingConfiguration:
    """The command line's training configuration (the deployed nVAD:
    2 x 150, TBPTT 50)."""
    parser = argparse.ArgumentParser(description="Train the unidirectional VAD model.")
    parser.add_argument("corpus_dir", help="Path to the preprocessed corpus with the .hdf files.")
    parser.add_argument("out_dir", help="Directory in which the model training will be saved.")
    parser.add_argument("--test_day", default="2022_11_04", help="Day used as offline test data.")
    parser.add_argument("--val_day", default="2022_11_03", help="Day used as validation data.")
    parser.add_argument("--epochs", default="8", help="Number of training epochs.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from out_dir/train_state.pth if present.")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="Trials per update (padded + masked batches; "
                             "the reference recipe uses 1).")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda).")
    args = parser.parse_args(argv)
    return TrainingConfiguration(
        nb_hidden_units=150,
        nb_layer=2,
        nb_epochs=int(args.epochs),
        batch_size=args.batch_size,
        num_workers=0,
        truncated_sequence_length=50,
        speech_corpus_root=Path(args.corpus_dir),
        out_dir=Path(args.out_dir),
        test_day=args.test_day,
        valid_day=args.val_day,
        resume=args.resume,
        device=args.device,
    )


if __name__ == "__main__":
    train_config = parse_config()
    out_dir = train_config.out_dir
    os.makedirs(out_dir.as_posix(), exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(name)-30s] [%(levelname)8s]: %(message)s",
        datefmt="%d.%m.%y %H:%M:%S",
        handlers=[logging.FileHandler(os.path.join(out_dir, "training.log"), "w+"),
                  logging.StreamHandler(sys.stderr)],
    )

    main(train_config)

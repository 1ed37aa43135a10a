"""Train the bidirectional speech decoding model (counterpart of
apps/train_bidirectional_model.py).

Leave-one-day-out with fixed test and validation days, full-sequence BPTT
per trial, RMSprop lr = 1e-4, masked MSE, dropout 0.5, the best checkpoint
by validation loss (``best_model.pth``), the training state after every
epoch (``train_state.pth``, resumed with ``--resume``), and every epoch the
predictions of up to 30 test and 30 train trials vocoded through the
asynchronous synthesis queue (the DSP vocoder: kernel D1 on the card).
The first fold only, unless ``--folds`` says more.

    python -m dss_tpu_torch.apps.train_bidirectional_model CORPUS OUT
        [--epochs 100] [--batch_size 1] [--folds 1] [--resume] [--device cpu]
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
from ..models.decoder import BidirectionalSpeechSynthesisModel
from ..models.lstm import seeded_init
from ..train.checkpoints import StoreBestModel, load_train_state, \
    save_train_state
from ..train.dataset import Recordings, corpus_files, datasets, \
    padded_batches
from ..train.synth_queue import AsynchronousSynthesisQueue
from ..train.trainer_decoder import DecoderTrainer
from ..utils.channels import SelectElectrodesOverSpeechAreas
from ..utils.cv import LeaveOneDayOut

logger = logging.getLogger("train_bidirectional_model.py")


@dataclass
class TrainingConfiguration:
    nb_hidden_units: int
    nb_layer: int
    nb_epochs: int
    batch_size: int
    num_workers: int
    speech_corpus_root: Path
    out_dir: Path
    test_day: str
    valid_day: str
    seed: int = 0
    resume: bool = False
    folds: int = 1
    device: str = "cuda"


def main(cfg: TrainingConfiguration, recordings: Recordings = None
         ) -> List[dict]:
    """Train on the ``.hdf`` corpus under ``cfg.speech_corpus_root``, or on
    ``recordings`` ({file name: recording}, as corpus preparation's
    ``prepare`` returns them) when given.  Returns each epoch's fold, mean
    train loss and validation loss."""
    device = resolve_device(cfg.device)
    out_dir = cfg.out_dir
    E = len(SelectElectrodesOverSpeechAreas())
    logger.info(f"Number of channels: {E}, {SelectElectrodesOverSpeechAreas()}")

    best_model = StoreBestModel(
        filename=os.path.join(out_dir, "best_model.pth"), head_name="regressor"
    )
    try:
        from torch.utils.tensorboard import SummaryWriter

        summary_writer = SummaryWriter(
            log_dir=os.path.join(out_dir, "tensorboard"))
    except ImportError:
        summary_writer = None

    feature_files = corpus_files(cfg.speech_corpus_root,
                                 "KeywordReading_Overt_R*.hdf", recordings)
    if not feature_files:
        feature_files = corpus_files(cfg.speech_corpus_root, "*.hdf",
                                     recordings)
    groups_by_day = defaultdict(list)
    for feature_file in feature_files:
        groups_by_day[feature_file.parent.name].append(feature_file)

    for sub in ("orig", "reco", "train"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    syn_queue = AsynchronousSynthesisQueue(nb_processes=8, device=device)
    synthesized_orig = False
    completed_folds = 0
    history = []
    for train_days, test_day in LeaveOneDayOut().split(
            X=groups_by_day.keys(), start_with_day=cfg.test_day):
        train_days, val_day = next(LeaveOneDayOut().split(
            train_days, start_with_day=cfg.valid_day))
        logger.info(
            f"Starting Leave-one-day-out cross validation with {test_day} as "
            f"test and {val_day} as validation day"
        )

        tr_files = [f.as_posix() for f in feature_files
                    if f.parent.name in train_days]
        va_files = [f.as_posix() for f in feature_files
                    if f.parent.name == val_day]
        tr_files = [f for f in tr_files if f not in va_files]
        te_files = sorted(f.as_posix() for f in feature_files
                          if f.parent.name == test_day)

        selection = SelectElectrodesOverSpeechAreas()
        tr_dataset, va_dataset, te_dataset = datasets(
            [tr_files, va_files, te_files], recordings, transform=selection)
        logger.info(repr(tr_dataset))

        model = seeded_init(BidirectionalSpeechSynthesisModel(
            nb_layer=cfg.nb_layer, nb_hidden_units=cfg.nb_hidden_units,
            nb_electrodes=E, dropout=0.5,
        ), cfg.seed)
        trainer = DecoderTrainer(model, learning_rate=1e-4, device=device)
        start_epoch = 0
        resume_path = os.path.join(out_dir, "train_state.pth")
        if cfg.resume and os.path.exists(resume_path):
            extra = load_train_state(resume_path, trainer.model,
                                     trainer.optimizer)
            start_epoch = int(extra.get("epoch", 0))
            logger.info(f"Resumed training state from epoch {start_epoch}.")

        n_params = sum(p.numel() for p in trainer.model.parameters())
        logger.info(
            f"Total number of trainable parameters of the "
            f"{type(model).__name__} model: {n_params:,}"
        )

        def predict_subset(dataset, limit=30):
            """Predictions and targets of the first ``limit`` trials."""
            preds, origs = [], []
            for i in range(min(limit, len(dataset))):
                x, y = dataset[i]
                xp, _, m = trainer.pad_trial(x, y)
                preds.append(trainer.predict(xp, m)[0, :len(x)].cpu().numpy())
                origs.append(y)
            return np.vstack(preds), np.vstack(origs)

        rng = np.random.default_rng(cfg.seed)
        for epoch in range(start_epoch, cfg.nb_epochs):
            if cfg.batch_size > 1:
                batches = padded_batches(tr_dataset, cfg.batch_size, rng=rng)
            else:
                batches = (trainer.pad_trial(*tr_dataset[int(idx)])
                           for idx in rng.permutation(len(tr_dataset)))
            train_loss = [float(trainer.train_step(xp, yp, m))
                          for xp, yp, m in batches]
            final_train_loss = sum(train_loss) / max(len(train_loss), 1)

            valid_loss = [float(trainer.evaluate(*trainer.pad_trial(*va_dataset[i])))
                          for i in range(len(va_dataset))]
            final_valid_loss = sum(valid_loss) / max(len(valid_loss), 1)
            history.append(dict(fold=completed_folds + 1, epoch=epoch + 1,
                                train_loss=final_train_loss,
                                valid_loss=final_valid_loss))

            logger.info(
                f"Epoch {epoch + 1:>04}: Train loss: {final_train_loss:.04f} "
                f"-- Validation loss: {final_valid_loss:.04f}"
            )
            if summary_writer is not None:
                summary_writer.add_scalars(
                    "Training vs. validation loss",
                    {"Train": final_train_loss, "Valid": final_valid_loss},
                    epoch + 1)
            best_model.update(trainer.model, validation_loss=final_valid_loss)
            save_train_state(resume_path, trainer.model, trainer.optimizer,
                             extra={"epoch": epoch + 1})

            # Per-epoch audible regression: vocode fixed test/train subsets.
            test_sentences, orig_sentences = predict_subset(te_dataset)
            train_sentences, orig_train = predict_subset(tr_dataset)

            if not synthesized_orig:
                synthesized_orig = True
                for name, data in (("orig.npy", orig_sentences),
                                   ("orig_train.npy", orig_train)):
                    filename = os.path.join(out_dir, "orig", name)
                    np.save(filename, data)
                    syn_queue.add_job(filename=filename, verbose=0)

            for sub, name, data in (
                    ("reco", "reco", test_sentences),
                    ("train", "train", train_sentences)):
                filename = os.path.join(out_dir, sub,
                                        f"{name}_epoch={epoch + 1:03d}.npy")
                np.save(filename, data)
                syn_queue.add_job(filename=filename, verbose=0)

        completed_folds += 1
        if completed_folds >= cfg.folds:
            break
    syn_queue.wait()
    return history


def parse_config(argv=None) -> TrainingConfiguration:
    """The command line's training configuration (the deployed decoder:
    2 x 100 bidirectional)."""
    parser = argparse.ArgumentParser(
        description="Train the bidirectional speech decoding model.")
    parser.add_argument("corpus_dir", help="Path to the preprocessed corpus with the .hdf files.")
    parser.add_argument("out_dir", help="Directory in which the model training will be saved.")
    parser.add_argument("--test_day", default="2022_11_04", help="Day used as offline test data.")
    parser.add_argument("--val_day", default="2022_11_03", help="Day used as validation data.")
    parser.add_argument("--epochs", default="100", help="Number of training epochs.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from out_dir/train_state.pth if present.")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="Trials per update (padded + masked batches; "
                             "the reference recipe uses 1).")
    parser.add_argument("--folds", type=int, default=1,
                        help="Number of leave-one-day-out folds to run "
                             "(reference default: 1).")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda).")
    args = parser.parse_args(argv)
    return TrainingConfiguration(
        nb_hidden_units=100,
        nb_layer=2,
        nb_epochs=int(args.epochs),
        batch_size=args.batch_size,
        num_workers=4,
        speech_corpus_root=Path(args.corpus_dir),
        out_dir=Path(args.out_dir),
        test_day=args.test_day,
        valid_day=args.val_day,
        resume=args.resume,
        folds=args.folds,
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

"""Day-specific z-score statistics for the online decoder (counterpart of
apps/baseline_offline.py).

Per-trial high-gamma features of one SyllableRepetition recording (a fresh
extractor per trial, the trial span padded by 0.04 s, on the device), the
channel mean and std stacked into ``<session>/normalization.npy`` for the
online system's z-scoring; the INI surface (``[Normalization]`` base_path,
session, normalization_file), ``--norm``, ``--overwrite`` and
``log.normalization.txt`` as in the JAX app.

    python -m dss_tpu_torch.apps.baseline_offline CONFIG.ini [--norm MAT]
        [--overwrite] [--device cpu]
"""

import argparse
import configparser
import logging
import os
import sys
from datetime import datetime
from typing import Optional, Tuple

import numpy as np

from ..utils.bci2000 import BCI2000MatFile
from .prepare_corpus import trial_features

logger = logging.getLogger("baseline_offline.py")


def get_default_session_name() -> str:
    return datetime.now().strftime("%Y_%m_%d")


def get_paths(settings_filename: str) -> Tuple[str, Optional[str]]:
    """(session directory, normalization .mat path or None) from the INI.
    Empty strings mean "unset"; an unset session falls back to today's
    date."""
    ini = configparser.ConfigParser()
    ini.read(settings_filename)
    sec = ini["Normalization"]
    session_dir = os.path.join(
        sec.get("base_path"),
        sec.get("session") or get_default_session_name())
    return session_dir, (sec.get("normalization_file") or None)


def main(session: str, norm_file: str, device=None) -> np.ndarray:
    """Write and return the [mean; std] statistics [2, channels]."""
    logger.info(f"Normalization source: {norm_file}")
    rec = BCI2000MatFile(mat_filename=norm_file)
    bad = rec.bad_channels()
    if bad is not None:
        logger.warning(f"Normalization recording marks bad channels {bad}")

    logger.info("Extracting per-trial high-gamma features for the "
                "channel statistics.")
    feats = np.concatenate(trial_features(rec, rec.trial_indices(), device))
    stats = np.vstack([feats.mean(axis=0), feats.std(axis=0)])
    out_path = os.path.join(session, "normalization.npy")
    logger.info(f"Writing [mean; std] ({stats.shape}) to {out_path}")
    np.save(out_path, stats)
    return stats


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Compute z-score statistics from .mat file")
    parser.add_argument("config", help="Path of the config file.")
    parser.add_argument("--norm", help="Path to the .mat file (overwrites the "
                                       "field normalization_file in config).")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda).")
    parser.add_argument("--overwrite", required=False, default=False,
                        action="store_true",
                        help="Allow overwriting the session folder.")
    args = parser.parse_args()

    session_dir, norm_file = get_paths(args.config)
    os.makedirs(session_dir, exist_ok=args.overwrite)
    norm_file = args.norm if args.norm is not None else norm_file

    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(name)-30s] [%(levelname)8s]: %(message)s",
        datefmt="%d.%m.%y %H:%M:%S",
        handlers=[
            logging.FileHandler(
                os.path.join(session_dir, "log.normalization.txt"), "w+"),
            logging.StreamHandler(sys.stderr),
        ],
    )

    if norm_file is None:
        logger.error("No normalization .mat given (INI field empty and no "
                     "--norm); nothing to do.")
        sys.exit(1)

    logger.info(f"args: config={args.config} norm={norm_file} "
                f"overwrite={args.overwrite}")
    logger.info(f"session dir: {session_dir}")
    main(session=session_dir, norm_file=norm_file, device=args.device)

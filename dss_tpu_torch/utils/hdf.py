"""HDF5 corpus container I/O (counterpart of dss_tpu/utils/hdf.py).

Containers hold the per-recording datasets ``{hga_activity,
lpc_coefficients, vad_labels, trial_ids}``.  h5py is imported inside the
two functions, not with the module: the port imports where h5py is not
installed, and only a call that reads or writes a container needs it (it
raises an ``ImportError`` naming h5py there; no other format is written in
its place).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "dss_tpu_torch.utils.hdf needs h5py to read or write .hdf "
            "corpus containers, and h5py is not installed") from e
    return h5py


def save_data_to_hdf(filename: str, parameters: Dict[str, np.ndarray],
                     overwrite: bool = False) -> bool:
    """Store time-aligned neural and acoustic data into an .hdf container.

    Returns False (and writes nothing) when the file exists and overwrite
    is disabled."""
    h5py = _h5py()
    if os.path.exists(filename) and not overwrite:
        print(
            f"File {filename} already exists and overwrite is set to False. "
            f"Training data is not stored."
        )
        return False

    with h5py.File(filename, "w") as hf:
        for container_name, data in parameters.items():
            hf.create_dataset(container_name, data=data)
    return True


def load_hdf(filename: str) -> Dict[str, np.ndarray]:
    """Load every dataset of an .hdf container into memory."""
    h5py = _h5py()
    with h5py.File(filename, "r") as hf:
        return {key: np.asarray(hf[key]) for key in hf.keys()}

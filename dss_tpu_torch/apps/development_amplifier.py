"""Simulated amplifier: replays a BCI2000 .mat recording over ZMQ in real
time (counterpart of apps/development_amplifier.py).

    python -m dss_tpu_torch.apps.development_amplifier SESSION.mat
        [--package_size N] [--loop] [--seconds S] [--duration D] [--port P]

A PUB socket on ``--port`` with SNDHWM=1 + CONFLATE=1 (drop-old) sends
BCI2000 GenericSignal packets (``runtime.units.pack_packet``: header
``=BBB HH`` = (4, 1, 2, channels, samples), float32 channel-major payload),
paced by a spin-wait to ``package_size / fs`` of real time; stimulus-code
changes are logged, and Ctrl-C closes with the packet statistics.  With
``dss_tpu_torch.apps.decode_online`` listening on the same port this is the
closed loop without a real amplifier.  ``zmq`` is imported only when an
``Amplifier`` is created.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Dict, List, Tuple

import numpy as np
from scipy.io import loadmat

from ..runtime.units import pack_packet

logger = logging.getLogger("dss_tpu_torch.development_amplifier")


def extract_stimuli_values(mat) -> List[str]:
    try:
        stimuli = mat["parameters"]["Stimuli"]["Value"]
    except KeyError:
        codes = mat["states"]["StimulusCode"]
        stimuli = np.asarray(
            [f"Unknown stimulus {c}" for c in np.unique(codes) if c != 0])
    stimuli = np.asarray(stimuli)
    if stimuli.ndim == 0:
        return [stimuli.item()]
    if stimuli.ndim == 1:
        return [stimuli[0]]
    return stimuli[0].tolist()


class Amplifier:
    """Streams neural data from a .mat file over the ZMQ interface at the
    recording's real-time rate."""

    def __init__(self, mat_file: str, package_size: int, loop: bool = False,
                 seconds: float = 0, port: int = 5556,
                 epsilon: float = 1e-7, duration: float = 0):
        import zmq

        self.mat_file = mat_file
        self.package_size = package_size
        self.epsilon = epsilon
        self.loop = loop
        self.duration = duration

        self.ecog, self.fs, self.stim_codes, self.stimuli = self._read_mat()
        if seconds > 0:
            self.ecog = self.ecog[: int(seconds * self.fs)]

        self.port = port
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.PUB)
        self.socket.setsockopt(zmq.SNDHWM, 1)
        self.socket.setsockopt(zmq.CONFLATE, 1)
        self.socket.bind(f"tcp://127.0.0.1:{self.port}")
        time.sleep(0.5)  # let subscribers connect before the first packet

        self.ecog_sample_index = 0
        self.package_counter = 0
        self.sample_counter = 0
        self.time_val = None
        self.time_val_initial = None

        logger.info(
            f"Initialized simulated amplifier for sending packets of neural "
            f"data over ZMQ (Packet size: {self.package_size}, Port: "
            f"{self.port}, Rate: {self.fs}).")

    def close(self) -> None:
        self.socket.close()
        self.context.destroy()
        if self.time_val_initial is not None:
            uptime = time.time() - self.time_val_initial
            logger.info(
                f"Ended after {uptime:.01f} seconds [{self.sample_counter} "
                f"samples sent in a total of {self.package_counter} packets].")

    def _read_mat(self) -> Tuple[np.ndarray, int, np.ndarray, Dict[int, str]]:
        mat = loadmat(self.mat_file, simplify_cells=True)
        fs = mat["parameters"]["SamplingRate"]["NumericValue"]
        gain = mat["parameters"]["SourceChGain"]["NumericValue"]
        ecog = (mat["signal"] * gain).astype(np.float32, copy=True, order="C")
        stim = {i + 1: s for i, s in enumerate(extract_stimuli_values(mat))}
        return ecog, fs, mat["states"]["StimulusCode"], stim

    def stream(self) -> None:
        logger.info("Streaming!")
        diff = np.flatnonzero(self.stim_codes[:-1] != self.stim_codes[1:]) + 1
        stim_code_index = 0

        self.time_val = time.time()
        self.time_val_initial = self.time_val
        while True:
            if self.duration > 0 and \
                    time.time() - self.time_val_initial >= self.duration:
                logger.info(f"Cancelled streaming after --duration "
                            f"{self.duration:.0f} s of wall clock.")
                break
            if not self.loop and self.ecog_sample_index >= len(self.ecog):
                logger.info("Cancelled streaming due to reaching end of ECoG "
                            "signal dataset.")
                break

            if len(diff) and self.ecog_sample_index <= diff[stim_code_index] \
                    < self.ecog_sample_index + self.package_size:
                code = self.stim_codes[diff[stim_code_index]]
                stim = self.stimuli.get(code, "")
                logger.info(f"Stimulus code changed to: {stim}")
                stim_code_index = (stim_code_index + 1) % len(diff)

            end = min(self.ecog_sample_index + self.package_size,
                      len(self.ecog))
            package = self.ecog[self.ecog_sample_index:end]
            if len(package) < self.package_size:
                missing = self.package_size - len(package)
                pad = self.ecog[:missing] if self.loop else np.zeros(
                    (missing, self.ecog.shape[1]), self.ecog.dtype)
                package = np.vstack([package, pad])
                self.ecog_sample_index = missing
            else:
                self.ecog_sample_index += self.package_size

            self.socket.send(pack_packet(package))
            self.package_counter += 1

            # Spin-wait to the real-time pacing contract.
            while time.time() - self.time_val < self.package_size / self.fs:
                time.sleep(self.epsilon)

            self.sample_counter += len(package)
            self.time_val = self.time_val_initial + \
                self.sample_counter / self.fs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Starts a simulated amplifier which reads neural data "
                    "from a provided .mat file and streams them via the ZMQ "
                    "interface to a receiver, so closed-loop systems can be "
                    "tested without an actual amplifier.")
    parser.add_argument("mat_file",
                        help="Path to the .mat file mirroring BCI2000 .dat "
                             "files.")
    parser.add_argument("--package_size", "-p", default=20,
                        help="Number of samples per package sent over ZMQ.")
    parser.add_argument("--loop", "-l", action="store_true",
                        help="Restart after all samples have been sent.")
    parser.add_argument("--seconds", "-s", default=0,
                        help="Truncate the SESSION to this many seconds of "
                             "recording before streaming (0 = all samples). "
                             "NB with --loop the truncated session replays "
                             "forever; bound wall time with --duration.")
    parser.add_argument("--duration", "-d", default=0, type=float,
                        help="Stop streaming after this much wall-clock "
                             "time (0 = unbounded).")
    parser.add_argument("--port", default=5556, type=int)
    args = parser.parse_args(argv)
    logger.info(f"development-amplifier {args.mat_file} --package_size "
                f"{args.package_size} --loop {args.loop} --seconds "
                f"{args.seconds}")
    amplifier = Amplifier(
        mat_file=args.mat_file, package_size=int(args.package_size),
        loop=args.loop, seconds=float(args.seconds), port=args.port,
        duration=args.duration)
    try:
        amplifier.stream()
    except KeyboardInterrupt:
        logger.info("Amplifier is going to gracefully close...")
    finally:
        amplifier.close()


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(name)-30s] [%(levelname)8s]: %(message)s",
        datefmt="%d.%m.%y %H:%M:%S")
    main()

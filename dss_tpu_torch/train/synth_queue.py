"""Background vocoding of intermediate training results (counterpart of
dss_tpu/train/synth_queue.py).

``add_job(filename)`` queues an ``.npy`` dump of LPC features [T, 20];
one worker thread vocodes each with the port's ``LPCNet`` (on the card:
kernel D1 for the ``dsp`` backend, the sampler kernel for ``net``) and
writes the ``.wav`` beside it, so training does not wait for synthesis.
``wait()`` drains the queue and stops the worker.  The vocoder is built
when the queue is (a missing card or a bad checkpoint raises there, not in
the worker); a job that fails is logged and skipped, as in the reference.
"""

from __future__ import annotations

import logging
import queue
import threading
from pathlib import Path

import numpy as np

from ..utils.audio import write_wav
from ..vocoder.lpcnet import LPCNet

logger = logging.getLogger("dss_tpu_torch.train.synth_queue")


class AsynchronousSynthesisQueue:
    def __init__(self, nb_processes: int = 1, backend: str = "dsp",
                 weights=None, device=None):
        # nb_processes is kept for the reference's signature: one worker
        # thread feeds the device.
        del nb_processes
        self._vocoder = LPCNet(backend=backend, weights=weights,
                               device=device)
        self._queue: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                break
            filename, verbose = item
            try:
                if verbose > 0:
                    logger.info(f"Synthesizing {filename}.")
                lpc = np.load(filename).astype(np.float32)
                self._vocoder.reset_decoder()
                pcm = self._vocoder.synthesize_frames(lpc)
                out = Path(filename).with_suffix(".wav").as_posix()
                write_wav(out, pcm, fs=16000)
                if verbose > 0:
                    logger.info(f"Finished synthesizing {filename}.")
            except Exception as e:  # as the reference: log and skip the job
                logger.error(
                    f"Could not synthesize {filename} due to an unexpected "
                    f"exception: {e}"
                )
            finally:
                self._queue.task_done()

    def add_job(self, filename: str, verbose: int = 0) -> None:
        self._queue.put((str(filename), verbose))

    def wait(self) -> None:
        """Block until all queued jobs are finished, then stop the worker."""
        self._queue.put(None)
        self._queue.join()
        self._worker.join()

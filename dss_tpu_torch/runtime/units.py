"""Streaming graph units of the online word path (counterpart of the fused
units in dss_tpu/runtime/units.py).

* ``ZMQConnector``        — BCI2000 GenericSignal ZMQ SUB ingest;
* ``PacketReplay``        — in-process replay of a recorded session;
* ``FusedFrontendVad``    — packet -> front end -> nVAD -> segments, one
  device->host read per packet;
* ``FusedDecoderVocoder`` — segment -> decoder -> neural vocoder -> int16
  PCM, one device->host read per word (plus one per later audio chunk);
* ``BinaryLogger``, ``VoiceActivityDetectionLogger``, ``DelayedWavLogger``
  and ``DelayedStdoutForSoX`` — the log taps and the audio sink.

Device work runs eagerly on the unit's device (``cuda`` unless the
settings say otherwise) inside a single-worker executor, so a slow device
call never freezes packet ingest and carried state stays ordered.
"""

from __future__ import annotations

import asyncio
import logging
import os
import struct
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path
from typing import Any, AsyncGenerator, Callable, List, Optional, Tuple

import numpy as np
import torch
from scipy.io.wavfile import write as _wavwrite

from ..device import resolve_device
from ..models.lstm import seeded_init
from ..models.torch_port import load_checkpoint
from ..ops.hga import HighGammaExtractor
from ..ops.ringbuffer import SpeechSegmentHistory, VoiceActivityDetectionSmoothing
from ..ops.sampler import prepare_sampler_weights
from ..vocoder.lpcnet import _load_params, _sparse_pattern_of
from ..vocoder.net import COND_BLOCK, FRAME_SIZE, LPCNetModel, \
    net_synthesize_frames, net_vocoder_init
from .graph import InputStream, OutputStream, Settings, Unit, coalescing, \
    publisher, subscriber
from .messages import ClosedLoopMessage, TimeSeriesMessage

logger = logging.getLogger("dss_tpu_torch.runtime.units")

Transforms = Optional[List[Callable]]

BCI2000_HEADER = struct.Struct("=BBB HH")
BCI2000_TOPIC = struct.Struct("=BBB").pack(4, 1, 2)


def _with_stamps(msg, extra, **kw):
    """``replace(msg, **kw)`` plus appended (stage, wall time) stamps."""
    if isinstance(msg, ClosedLoopMessage):
        kw["stamps"] = getattr(msg, "stamps", ()) + tuple(extra)
    return replace(msg, **kw)


def _anonymize(msg, **kw):
    """``replace(msg, **kw)`` with latency bookkeeping stripped (later audio
    chunks of a word are not fresh word latencies)."""
    if isinstance(msg, ClosedLoopMessage):
        kw.setdefault("received_at", None)
        kw.setdefault("stamps", ())
    return replace(msg, **kw)


def interpret_bci2000_packet(data: bytes) -> np.ndarray:
    """GenericSignal packet -> float64 [samples, channels]: header
    ``=BBB HH`` (descriptor, type, topic, channels, samples), then float32
    values channel-major."""
    _d, _s, _t, ch, sa = BCI2000_HEADER.unpack(data[:BCI2000_HEADER.size])
    payload = np.frombuffer(data[BCI2000_HEADER.size:], np.float32)
    return payload.reshape(ch, sa).T.astype(np.float64, order="C")


# region Sources
class ZMQConnectorSettings(Settings):
    fs: int
    port: int = 5556
    address: str = "localhost"
    idle_timeout: Optional[float] = None  # end after this many idle seconds


class ZMQConnector(Unit):
    """SUB socket on the BCI2000 GenericSignal topic with drop-old
    semantics (RCVHWM=1), stamping the ingest time on each message.
    ``zmq`` is imported only here, when the unit starts."""

    SETTINGS: ZMQConnectorSettings
    OUTPUT = OutputStream(ClosedLoopMessage)

    def initialize(self) -> None:
        import zmq
        import zmq.asyncio

        self._context = zmq.asyncio.Context()
        self._socket = self._context.socket(zmq.SUB)
        self._socket.setsockopt(zmq.RCVHWM, 1)
        self._socket.connect(f"tcp://{self.SETTINGS.address}:"
                             f"{self.SETTINGS.port}")
        self._socket.subscribe(BCI2000_TOPIC)

    def shutdown(self) -> None:
        self._socket.close()
        self._context.destroy()

    @publisher(OUTPUT)
    async def process(self) -> AsyncGenerator:
        while not self._socket.closed:
            if self.SETTINGS.idle_timeout is not None:
                try:
                    data = await asyncio.wait_for(
                        self._socket.recv(),
                        timeout=self.SETTINGS.idle_timeout)
                except asyncio.TimeoutError:
                    logger.info("ZMQConnector idle timeout — ending stream.")
                    return
            else:
                data = await self._socket.recv()
            yield self.OUTPUT, ClosedLoopMessage(
                data=interpret_bci2000_packet(data), fs=self.SETTINGS.fs,
                received_at=time.time())


class PacketReplaySettings(Settings):
    data: np.ndarray            # [T, raw_channels] session
    fs: int
    package_size: int = 40
    # Seconds between packets (the amplifier's period); None publishes as
    # fast as the graph's bounded edges accept.
    period: Optional[float] = None


class PacketReplay(Unit):
    """In-process packet source: replays a session in ``package_size``
    packets, stamped at publication like the ZMQ ingest."""

    SETTINGS: PacketReplaySettings
    OUTPUT = OutputStream(ClosedLoopMessage)

    @publisher(OUTPUT)
    async def process(self) -> AsyncGenerator:
        s = self.SETTINGS
        t0 = time.perf_counter()
        for n, k in enumerate(range(0, len(s.data) - s.package_size + 1,
                                    s.package_size)):
            if s.period is not None:
                await asyncio.sleep(max(0.0, t0 + n * s.period
                                        - time.perf_counter()))
            yield self.OUTPUT, ClosedLoopMessage(
                data=np.asarray(s.data[k:k + s.package_size], np.float64),
                fs=s.fs, received_at=time.time())
# endregion


# region Logging units
class LoggerSettings(Settings):
    filename: str
    overwrite: bool
    config_filename: Optional[str] = None


class BinaryLogger(Unit):
    """Append each message's raw ``data.tobytes()`` to a binary log."""

    SETTINGS: LoggerSettings
    INPUT = InputStream(TimeSeriesMessage)

    def initialize(self) -> None:
        filename = os.path.abspath(self.SETTINGS.filename)
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        if os.path.isfile(filename) and not self.SETTINGS.overwrite:
            raise PermissionError(f"{filename} exists and overwrite is "
                                  f"disabled.")
        self._fd = open(filename, mode="wb")

    def shutdown(self) -> None:
        self._fd.flush()
        self._fd.close()

    @subscriber(INPUT)
    async def write(self, message: TimeSeriesMessage) -> None:
        self._fd.write(np.asarray(message.data).tobytes())


class VoiceActivityDetectionLogger(Unit):
    """``.lab`` rows ``start<TAB>stop<TAB>"N frames"`` per segment."""

    SETTINGS: LoggerSettings
    INPUT = InputStream(ClosedLoopMessage)

    def initialize(self) -> None:
        filename = os.path.abspath(self.SETTINGS.filename)
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        if os.path.isfile(filename) and not self.SETTINGS.overwrite:
            raise PermissionError(f"{filename} exists and overwrite is "
                                  f"disabled.")
        self._fd = open(filename, mode="w")

    def shutdown(self) -> None:
        self._fd.flush()
        self._fd.close()

    @subscriber(INPUT)
    async def write(self, message: ClosedLoopMessage) -> None:
        start = message.previous_frames * 0.01
        stop = (message.previous_frames + len(message.data)) * 0.01
        self._fd.write(f"{start:.02f}\t{stop:.02f}\t"
                       f"{len(message.data)} frames\n")


class DelayedWavLoggerSettings(Settings):
    base_path: Path
    overwrite: bool
    prefix: Optional[str] = None


class DelayedWavLogger(Unit):
    """Save each synthesized segment as ``{prefix}_{counter:05d}.wav``."""

    SETTINGS: DelayedWavLoggerSettings
    INPUT = InputStream(TimeSeriesMessage)

    def initialize(self) -> None:
        os.makedirs(self.SETTINGS.base_path, exist_ok=True)
        self._counter = 1

    @subscriber(INPUT)
    async def write(self, message: TimeSeriesMessage) -> None:
        prefix = self.SETTINGS.prefix or ""
        filename = os.path.join(Path(self.SETTINGS.base_path).as_posix(),
                                f"{prefix}_{self._counter:05d}.wav")
        self._counter += 1
        if not (os.path.isfile(filename) and not self.SETTINGS.overwrite):
            _wavwrite(filename, 16000, np.asarray(message.data))
# endregion


def _load_lstm(arch, params: Optional[dict], weights: Optional[Path],
               bidirectional: bool, head_name: str, device) -> torch.nn.Module:
    model = arch(**(params or {}))
    if weights is not None:
        model.load_state_dict(load_checkpoint(
            Path(weights).as_posix(), model.nb_layer,
            bidirectional=bidirectional, head_name=head_name))
    else:
        seeded_init(model, 0)
    return model.to(device).eval()


# region Fused packet path
class FusedFrontendVadSettings(Settings):
    """Front end + nVAD in one device call per packet."""

    nb_features: int
    fs: int
    buffer_size: int
    context_frames: int = 0
    window_length: float = 0.05
    window_shift: float = 0.01
    pre_transforms: Transforms = None
    post_transforms: Transforms = None
    package_size: int = 40
    raw_channels: int = 129
    vad_architecture: Any = None
    vad_weights_path: Optional[Path] = None
    vad_parameters: Optional[dict] = None
    # Backlog-drain batch sizes (in packets), warmed at startup.
    coalesce_packets: Tuple[int, ...] = (2, 4, 8)
    device: Optional[str] = None  # None = cuda


class FusedFrontendVad(Unit):
    """Packet -> features -> VAD labels in one device call with one packed
    device->host read.  Publishes the feature stream on FEATURES (log.hga
    tap) and completed speech segments on OUTPUT.

    Backlog coalescing: the subscriber drains the packets already queued
    (graph.coalescing) and runs them as one call of 2, 4 or 8 packets —
    the filter, framer and VAD recurrences are streaming-equivalent over
    concatenation — so a slow call never builds an unbounded backlog."""

    SETTINGS: FusedFrontendVadSettings
    INPUT = InputStream(ClosedLoopMessage, maxsize=8)
    FEATURES = OutputStream(ClosedLoopMessage)
    OUTPUT = OutputStream(ClosedLoopMessage)

    def initialize(self) -> None:
        s = self.SETTINGS
        self._device = resolve_device(s.device)
        self._extractor = HighGammaExtractor(
            fs=s.fs, nb_electrodes=s.nb_features,
            window_length=s.window_length, window_shift=s.window_shift,
            pre_transforms=s.pre_transforms, post_transforms=s.post_transforms,
            device=self._device)
        self._model = _load_lstm(s.vad_architecture, s.vad_parameters,
                                 s.vad_weights_path, False, "classifier",
                                 self._device)
        self._history = SpeechSegmentHistory(
            nb_features=s.nb_features, buffer_size=s.buffer_size,
            context=s.context_frames)
        self._smoothing = VoiceActivityDetectionSmoothing(
            nb_features=s.nb_features, context_frames=5)
        self._frame_counter = 0
        self._first = True
        self._fe_state = self._extractor.init_state()
        self._vad_state = self._model.create_new_initial_state(1)
        self.step_ms: List[float] = []  # wall time of each device call
        # Its own stream: packets must not queue behind a word's vocoder
        # chunks on the default stream (hundreds of ms per word).
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        # Warm every call size against throwaway states: torch runs
        # eagerly (nothing compiles), but the first call at a shape pays
        # cuDNN plan selection, allocator growth and the kernels' build.
        self._sizes = sorted({1, *(s.coalesce_packets or ())}, reverse=True)
        for n in self._sizes:
            dummy = torch.zeros((n * s.package_size, s.raw_channels),
                                device=self._device)
            self._packet_path(self._extractor.init_state(),
                              self._model.create_new_initial_state(1),
                              dummy)[2].cpu()
        self._executor = ThreadPoolExecutor(max_workers=1)

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True)

    @torch.no_grad()
    def _packet_path(self, fe_state, vad_state, packet: torch.Tensor):
        feats, fe_state = self._extractor.packet_step(fe_state, packet)
        logits, vad_state = self._model(feats[None], vad_state)
        labels = torch.argmax(logits, dim=-1)[0]
        # Features and labels leave the device in ONE read.
        packed = torch.cat([feats, labels[:, None].to(feats.dtype)], dim=1)
        return fe_state, vad_state, packed

    def _step(self, data: np.ndarray):
        t0 = time.perf_counter()
        with torch.cuda.stream(self._stream):
            packet = torch.as_tensor(np.asarray(data, np.float32)).to(
                self._device)
            self._fe_state, self._vad_state, packed = self._packet_path(
                self._fe_state, self._vad_state, packet)
            packed = packed.cpu().numpy()  # the one device->host read
        self._t_device_done = time.time()
        self.step_ms.append((time.perf_counter() - t0) * 1000.0)
        return packed[:, :-1].astype(np.float64), packed[:, -1].astype(np.int32)

    @subscriber(INPUT)
    @publisher(FEATURES)
    @publisher(OUTPUT)
    @coalescing(8)
    async def process(self, msgs) -> AsyncGenerator:
        loop = asyncio.get_running_loop()
        i = 0
        while i < len(msgs):
            take = next(n for n in self._sizes if n <= len(msgs) - i)
            chunk = msgs[i:i + take]
            i += take
            # Stamps ride the EARLIEST packet of the chunk.
            msg = chunk[0]
            data = (msg.data if take == 1
                    else np.concatenate([m.data for m in chunk], axis=0))
            t_dispatch = time.time()
            feats, labels = await loop.run_in_executor(
                self._executor, self._step, data)
            if self._first:
                k = self._extractor.warmup_frames(data.shape[0])
                feats, labels = feats[k:], labels[k:]
                self._first = False

            yield self.FEATURES, replace(
                msg, data=feats, fs=1 / self.SETTINGS.window_shift)

            data, predictions = self._smoothing.insert(
                data=feats.astype(np.float32), speech_labels=labels)
            segments = self._history.insert(data=data,
                                            speech_labels=predictions)
            self._frame_counter += len(feats)
            for segment in segments:
                previous_frames = (
                    self._frame_counter - len(segment)
                    - (len(feats) - int(np.count_nonzero(predictions))))
                yield self.OUTPUT, _with_stamps(
                    msg, (("fe_dispatch", t_dispatch),
                          ("fe_device_done", self._t_device_done),
                          ("seg_close", time.time())),
                    data=segment, fs=100, previous_frames=previous_frames)
# endregion


# region Fused word path
class FusedDecoderVocoderSettings(Settings):
    """Bidirectional decode + neural vocoder (the ``net`` backend) per
    word."""

    path_to_model_weights: Optional[str]
    model: Any
    params: Optional[dict]
    vocoder_weights: Optional[str] = None
    length_multiple: int = 50  # segment padding bucket (masked; exact)
    # Decoder segment lengths warmed at startup (2 * length_multiple too).
    prewarm_frames: Tuple[int, ...] = (50, 150, 200, 250, 300)
    # Ship the first 50-frame chunk of a word as soon as it is vocoded;
    # later chunks follow as each lands.  Needs length_multiple % 50 == 0.
    chunk_emission: bool = True
    # Online anti-crackle squelch (vocoder/net.py QUIET_C0).
    quiet_sharpen: bool = True
    device: Optional[str] = None  # None = cuda


class FusedDecoderVocoder(Unit):
    """Decode one completed speech segment and vocode it.  The decoder's
    state is fresh per segment; the vocoder's carries across segments.
    Publishes decoded features on LPC (log.lpc tap), int16 audio chunks in
    order on OUTPUT, and the whole word on WORD (wav tap)."""

    SETTINGS: FusedDecoderVocoderSettings
    INPUT = InputStream(TimeSeriesMessage)
    LPC = OutputStream(TimeSeriesMessage)
    OUTPUT = OutputStream(TimeSeriesMessage)
    WORD = OutputStream(TimeSeriesMessage)

    def initialize(self) -> None:
        s = self.SETTINGS
        if s.vocoder_weights is None:
            raise ValueError("FusedDecoderVocoder needs vocoder_weights")
        self._device = resolve_device(s.device)
        self._model = _load_lstm(s.model, s.params, s.path_to_model_weights,
                                 True, "regressor", self._device)
        self._voc_params = _load_params(s.vocoder_weights, self._device)
        self._voc_model = LPCNetModel.from_params(self._voc_params)
        self._sampler_w = prepare_sampler_weights(self._voc_params)
        _pattern, kept = _sparse_pattern_of(self._voc_params)
        logger.info(f"vocoder GRU-A mask keeps {kept:.1%} of [16 x 128] "
                    f"tiles (this sampler kernel runs the dense product)")
        self._voc_state = net_vocoder_init(self._voc_model, batch=1,
                                           device=self._device)
        self._chunk = COND_BLOCK
        self._chunked = bool(s.chunk_emission) \
            and s.length_multiple % COND_BLOCK == 0
        self.word_ms: List[float] = []  # segment in -> first audio read
        # Warm the decoder at every bucket and the vocoder on one block
        # (every chunk has the same 50-frame shape), on throwaway state.
        electrodes = self._model.nb_electrodes
        # n - 1 valid frames: live words are rarely whole buckets, and the
        # padded (packed-sequence) LSTM path has its own cuDNN plans.
        for n in sorted({2 * s.length_multiple, *(s.prewarm_frames or ())}):
            self._padded_features(np.zeros((n, electrodes), np.float32), n - 1)
        state = net_vocoder_init(self._voc_model, batch=1, device=self._device)
        self._vocode(state, torch.zeros((1, self._chunk, 20),
                                        device=self._device))[0].cpu()
        self._executor = ThreadPoolExecutor(max_workers=1)

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True)

    @torch.no_grad()
    def _padded_features(self, data: np.ndarray, T: int):
        """Decode ``data`` [T, E] padded to the bucket: returns (pred
        [1, T, F] of the valid frames, feats [1, Tp, F] whose padded tail
        repeats the last valid frame — the vocoder then never consumes
        padding garbage)."""
        mult = self.SETTINGS.length_multiple
        Tp = -(-T // mult) * mult
        x = torch.zeros((1, Tp, data.shape[1]))
        x[0, :T] = torch.as_tensor(data[:T])
        mask = torch.zeros((1, Tp))
        mask[0, :T] = 1.0
        pred, _ = self._model(x.to(self._device), mask=mask)
        feats = pred.clone()
        feats[:, T:] = pred[:, T - 1:T]
        return pred[:, :T], feats

    def _vocode(self, state, feats):
        """Neural vocoder on feats [1, n, 20] -> (int16 PCM as packed f32
        pairs, new state); the clip -> truncate conversion of the
        reference's int16 sink."""
        pcm, state = net_synthesize_frames(
            self._voc_model, self._voc_params, state, feats,
            quiet_sharpen=self.SETTINGS.quiet_sharpen,
            sampler_weights=self._sampler_w)
        pcm16 = torch.clamp(pcm.reshape(-1) * 32767.0, -32768, 32767
                            ).to(torch.int16)
        return pcm16.view(torch.float32), state

    def _split(self, packed: np.ndarray, T: int):
        n = T * self._model.nb_outputs
        return (packed[:n].reshape(T, self._model.nb_outputs),
                packed[n:].view(np.int16))

    def _decode_and_vocode(self, data: np.ndarray):
        """Single shot: decode and vocode the whole word, one read."""
        t0 = time.perf_counter()
        T = len(data)
        pred, feats = self._padded_features(data, T)
        bits, self._voc_state = self._vocode(self._voc_state, feats)
        packed = torch.cat([pred.reshape(-1), bits]).cpu().numpy()
        self._t_device_done = time.time()
        self.word_ms.append((time.perf_counter() - t0) * 1000.0)
        lpc, audio = self._split(packed, T)
        return lpc, audio[: T * FRAME_SIZE]

    def _decode_head(self, data: np.ndarray):
        """Chunked word start: decode, vocode the first chunk, and read
        back features + that chunk's audio — the one read on the
        first-audio critical path.  Returns the padded features for the
        tail chunks."""
        t0 = time.perf_counter()
        T = len(data)
        pred, feats = self._padded_features(data, T)
        bits, self._voc_state = self._vocode(self._voc_state,
                                             feats[:, :self._chunk])
        packed = torch.cat([pred.reshape(-1), bits]).cpu().numpy()
        self._t_device_done = time.time()
        self.word_ms.append((time.perf_counter() - t0) * 1000.0)
        lpc, audio0 = self._split(packed, T)
        return lpc, audio0[: min(T, self._chunk) * FRAME_SIZE], feats, T

    def _tail_chunk(self, feats: torch.Tensor, k: int, T: int) -> np.ndarray:
        """Vocode and read tail chunk ``k``, trimmed to the word's valid
        frames and clamped at zero: a chunk wholly inside the repeat-pad
        is synthesized for state continuity but ships nothing.

        Tails run when they are read, not all queued behind the head: a
        chunk is some 450 small launches, and queueing a word's tails
        fills the CUDA launch queue, which blocks the host — and the head's
        read — until the card has drained most of them."""
        c = self._chunk
        bits, self._voc_state = self._vocode(self._voc_state,
                                             feats[:, k * c:(k + 1) * c])
        valid = max(0, min(T - k * c, c))
        return bits.cpu().numpy().view(np.int16)[: valid * FRAME_SIZE]

    @subscriber(INPUT)
    @publisher(LPC)
    @publisher(OUTPUT)
    @publisher(WORD)
    async def decode(self, msg: TimeSeriesMessage) -> AsyncGenerator:
        loop = asyncio.get_running_loop()
        data = np.asarray(msg.data, np.float32)
        t_dispatch = time.time()
        if not self._chunked:
            lpc, audio = await loop.run_in_executor(
                self._executor, self._decode_and_vocode, data)
            stamps = (("dv_dispatch", t_dispatch),
                      ("dv_device_done", self._t_device_done))
            yield self.LPC, replace(msg, data=lpc, fs=100)
            yield self.OUTPUT, _with_stamps(msg, stamps, data=audio,
                                            fs=16000)
            yield self.WORD, _anonymize(msg, data=audio, fs=16000)
            return

        lpc, audio0, feats, T = await loop.run_in_executor(
            self._executor, self._decode_head, data)
        n_chunks = feats.shape[1] // self._chunk
        stamps = (("dv_dispatch", t_dispatch),
                  ("dv_device_done", self._t_device_done))
        yield self.LPC, replace(msg, data=lpc, fs=100)
        # The first chunk carries the word's latency stamps.
        yield self.OUTPUT, _with_stamps(msg, stamps, data=audio0, fs=16000)
        parts = [audio0]
        for i in range(1, n_chunks):
            audio_k = await loop.run_in_executor(
                self._executor, self._tail_chunk, feats, i, T)
            parts.append(audio_k)
            if len(audio_k) == 0 and i != n_chunks - 1:
                continue  # all-pad chunk: nothing to ship
            if i == n_chunks - 1:
                out = _with_stamps(msg, (("dv_dispatch", t_dispatch),
                                         ("dv_word_complete", time.time())),
                                   data=audio_k, fs=16000)
            else:
                out = _anonymize(msg, data=audio_k, fs=16000)
            yield self.OUTPUT, out
        word = np.concatenate(parts) if len(parts) > 1 else audio0
        yield self.WORD, _anonymize(msg, data=word, fs=16000)
# endregion


# region Output unit
class DelayedStdoutForSoX(Unit):
    """Write int16 PCM to stdout for ``play -t raw -r 16000 ...``, and log
    each word's ingest->audio latency (p50 at shutdown)."""

    INPUT = InputStream(ClosedLoopMessage)

    def initialize(self) -> None:
        self.latencies_ms: List[float] = []

    @subscriber(INPUT)
    async def print(self, msg: ClosedLoopMessage) -> None:
        sys.stdout.buffer.write(np.asarray(msg.data).tobytes())
        sys.stdout.flush()
        if getattr(msg, "received_at", None) is None:
            return  # interior audio chunk of a word
        latency_ms = (time.time() - msg.received_at) * 1000.0
        if any(name == "dv_word_complete"
               for name, _ in getattr(msg, "stamps", ())):
            logger.info(f"word complete: ingest->last_audio "
                        f"{latency_ms:.1f} ms")
            return
        self.latencies_ms.append(latency_ms)
        logger.info(f"segment audio out: {len(msg.data)} samples, "
                    f"ingest->audio {latency_ms:.1f} ms")

    def shutdown(self) -> None:
        if self.latencies_ms:
            logger.info(f"ingest->audio latency over {len(self.latencies_ms)}"
                        f" segments: p50 "
                        f"{float(np.percentile(self.latencies_ms, 50)):.1f} ms")
# endregion

"""Batched inference API: one-stage JETS, VITS2 and Text2Wav (JOINT),
two-stage FastSpeech2, AdaSpeech or Matcha + HiFi-GAN synthesis.

Counterpart of ``viet_tts_tpu/infer/api.py``: ``OneStageTTS`` for JETS,
VITS2 and JOINT and ``TwoStageTTS`` for FastSpeech2, AdaSpeech and Matcha (acoustic model ->
mel -> HiFi-GAN): text front-end, bucketed batches, synthesis on the card,
waveform export. A port checkpoint is a directory with

- ``model.pt``: the model's ``state_dict`` (``torch.save``), or, in a
  trainer's output directory, the newest
  ``generator_epoch{E}_iteration{I}_statedict.pt`` (its ``model`` entry);
- ``config.json``: ``{"audio": ..., "models": {"jets": {"generator_params":
  ...}, "vits2": ..., "fastspeech2": ..., "adaspeech": ..., "matcha": ...,
  "hifigan": ...}}`` and, for
  JOINT, the ``version`` of its acoustic half (a ``config.yaml`` of the
  same shape is read too, through the port's YAML-subset reader); without
  either, the package's ``config.py``;
- optional ``speakers.json`` (speaker name -> id) and, for an acoustic
  model, ``accents.json`` and ``stats.json`` (pitch / energy statistics;
  for Matcha the dataset's ``mel_mean`` / ``mel_std``, which it cannot do
  without: there is no default).

A two-stage pair is two such directories: the acoustic one (whose config
also names the vocoder's geometry, as in the JAX package) and the
vocoder's. The JAX API's data-, sequence- and pipeline-parallel serving
flags are still to be ported (item 15 of ROADMAP.md section 1).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from viet_tts_torch import config as port_config
from viet_tts_torch.data.batching import DEFAULT_TEXT_BUCKETS, bucket_for
from viet_tts_torch.device import resolve_device
from viet_tts_torch.models import ACOUSTIC_FAMILIES, build_acoustic
from viet_tts_torch.text import NUM_SYMBOLS, VietnameseG2P, basic_clean, symbols_to_ids
from viet_tts_torch.train.checkpoint import model_state_dict, scan_checkpoint
from viet_tts_torch.utils.yaml_subset import load_file

WEIGHTS_NAME = "model.pt"


def default_conf() -> Dict[str, Any]:
    """The shipped configuration: audio settings, the JETS generator params,
    the VITS2, FastSpeech2, AdaSpeech, Matcha and HiFi-GAN sections."""
    return {
        "audio": port_config.default_audio(),
        "models": {"jets": {"generator_params": port_config.jets_generator_params()},
                   "vits2": port_config.vits2_params(),
                   "fastspeech2": port_config.fastspeech2_params(),
                   "adaspeech": port_config.adaspeech_params(),
                   "matcha": port_config.matcha_params(),
                   "hifigan": port_config.hifigan_params()},
    }


def load_sidecars(ckpt_dir: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    cfg_json = os.path.join(ckpt_dir, "config.json")
    cfg_yaml = os.path.join(ckpt_dir, "config.yaml")
    if os.path.exists(cfg_json):
        with open(cfg_json, "r", encoding="utf8") as f:
            out["conf"] = json.load(f)
    elif os.path.exists(cfg_yaml):
        out["conf"] = load_file(cfg_yaml)
    for name in ("speakers", "accents", "stats"):
        path = os.path.join(ckpt_dir, f"{name}.json")
        if os.path.exists(path):
            with open(path, "r", encoding="utf8") as f:
                out[name] = json.load(f)
    return out


def save_checkpoint(ckpt_dir: str, model: torch.nn.Module, conf: Dict[str, Any],
                    speakers: Optional[Dict[str, int]] = None,
                    accents: Optional[Dict[str, int]] = None,
                    stats: Optional[Dict[str, Any]] = None) -> str:
    """Write a port checkpoint directory; returns the weights' path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, WEIGHTS_NAME)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, path)
    with open(os.path.join(ckpt_dir, "config.json"), "w", encoding="utf8") as f:
        json.dump(conf, f, indent=1)
    for name, sidecar in (("speakers", speakers), ("accents", accents), ("stats", stats)):
        if sidecar:
            with open(os.path.join(ckpt_dir, f"{name}.json"), "w", encoding="utf8") as f:
                json.dump(sidecar, f)
    return path


def resolve_checkpoint(path: str) -> str:
    """A checkpoint directory or a weights file -> the weights file: a
    directory's ``model.pt``, else its newest trainer checkpoint
    (``generator_epoch*_iteration*_statedict.pt``, by iteration)."""
    if os.path.isdir(path):
        weights = os.path.join(path, WEIGHTS_NAME)
        if not os.path.exists(weights):
            weights = scan_checkpoint(path, "generator") or weights
        path = weights
    if not os.path.exists(path):
        raise FileNotFoundError(f"no port checkpoint at {path}")
    return path


def _resolve_packed(packed_vocoder: Optional[bool]) -> bool:
    """Always False: the JAX package packs the vocoder tail into TPU MXU
    lanes, a layout whose output equals the plain path and which has no use
    on the card. ``packed_vocoder`` is accepted for the JAX signature."""
    del packed_vocoder
    return False


def split_sentences(text: str, max_words: int = 40) -> List[str]:
    """Split long-form text into synthesis-sized sentences: on sentence
    punctuation, then over-long pieces at commas or word boundaries."""
    pieces = [p.strip() for p in re.split(r"(?<=[.!?;…])\s+", text) if p.strip()]
    out = []
    for p in pieces:
        words = p.split()
        while len(words) > max_words:
            cut = max_words
            for i in range(max_words, max_words // 2, -1):
                if words[i - 1].endswith(","):
                    cut = i
                    break
            out.append(" ".join(words[:cut]))
            words = words[cut:]
        if words:
            out.append(" ".join(words))
    return out


class _TTSBase:
    """Shared text front-end + batching."""

    def __init__(self, sr: int = 22050, hop: int = 256):
        self.g2p = VietnameseG2P()
        self.sr = sr
        self.hop = hop

    def stream_long(self, text: str, max_words: int = 40,
                    batch_sentences: int = 8, **kwargs) -> Iterator[np.ndarray]:
        """Yield waveforms sentence by sentence, ``batch_sentences`` per
        synthesis call, so playback can start after the first batch."""
        sentences = split_sentences(text, max_words=max_words)
        for i in range(0, len(sentences), max(batch_sentences, 1)):
            for wav in self(sentences[i: i + batch_sentences], **kwargs):
                yield wav

    def encode_texts(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, int]:
        """texts -> (ids (B, T), lengths (B,), T bucket)."""
        seqs = []
        for t in texts:
            phones = self.g2p(basic_clean(t), get_boundary=False)
            seqs.append(symbols_to_ids(phones))
        max_len = max(len(s) for s in seqs)
        T = bucket_for(max_len, DEFAULT_TEXT_BUCKETS)
        ids = np.zeros((len(seqs), T), np.int64)
        lens = np.zeros(len(seqs), np.int64)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s[:T]
            lens[i] = min(len(s), T)
        return ids, lens, T


class OneStageTTS(_TTSBase):
    """Fused text -> waveform synthesis: JETS, VITS2 (``models.vits2``), or
    Text2Wav (``model_type="JOINT"``: FastSpeech2, AdaSpeech or Matcha ->
    HiFi-GAN in one model, built from the checkpoint's ``config.json``
    (``version``, ``models.<version>``, ``models.hifigan``) with its
    ``stats.json`` and ``accents.json``).

    ``fused_vocoder`` routes the HiFi-GAN vocoder's ch <= 64 stages to
    kernel K2; None (the default) takes the family's own route: K2 for JETS
    and JOINT, the plain generator for VITS2, whose decoder is its own
    stack (asking for the fused route on VITS2 raises, as in the JAX
    package). JOINT's acoustic half runs the attention route its config
    names (``flash``: kernels K4 / K5 / K6); VITS2's attention is plain
    PyTorch. VITS2 samples at the JAX API's noise scales (0 and 0: no
    noise)."""

    def __init__(self, checkpoint_path: str, model_type: str = "JETS",
                 max_mel_frames: int = 1008, half: bool = False,
                 fused_vocoder: Optional[bool] = None,
                 packed_vocoder: Optional[bool] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.model_type = model_type.lower()
        if self.model_type not in ("jets", "vits2", "joint"):
            raise ValueError(f"unknown one-stage model_type {model_type!r}")
        if self.model_type == "vits2" and fused_vocoder:
            raise ValueError(
                "fused_vocoder is only wired into the HiFiGAN-family decoders (jets / "
                "two-stage); the VITS2 generator has its own decode stack")
        if fused_vocoder is None:
            fused_vocoder = self.model_type != "vits2"
        self.device = resolve_device(device)
        ckpt_path = resolve_checkpoint(checkpoint_path)
        side = load_sidecars(os.path.dirname(ckpt_path))
        self.conf = side.get("conf") or default_conf()
        self.speakers = side.get("speakers") or {}
        self.accents = side.get("accents") or {}
        self.stats = side.get("stats") or port_config.DEFAULT_STATS
        super().__init__(
            sr=self.conf["audio"]["signal"]["sampling_rate"],
            hop=self.conf["audio"]["stft"]["hop_length"],
        )
        self.max_mel_frames = max_mel_frames
        self.n_mels = self.conf["audio"]["mel"]["channels"]
        n_spk = max(len(self.speakers), 1)
        if self.model_type == "jets":
            from viet_tts_torch.models.jets import JETS

            jets_hp = dict(self.conf["models"]["jets"]["generator_params"])
            if fused_vocoder:
                jets_hp["fused_mrf"] = True
            jets_hp["packed_tail"] = _resolve_packed(packed_vocoder)
            model = JETS(n_symbols=NUM_SYMBOLS, n_channels=self.n_mels, hparams=jets_hp,
                         n_speakers=n_spk)
        elif self.model_type == "vits2":
            from viet_tts_torch.models.vits2 import VITS2

            del packed_vocoder  # accepted for the JAX signature (see _resolve_packed)
            vits_hp = self.conf["models"]["vits2"]
            model = VITS2(NUM_SYMBOLS, vits_hp, n_speakers=n_spk,
                          spec_channels=self.n_mels if vits_hp.get(
                              "use_mel_posterior_encoder", True) else None)
        else:
            from viet_tts_torch.models.text2wav import Text2Wav

            model = Text2Wav(NUM_SYMBOLS, self.n_mels, self.conf, self.stats,
                             n_speakers=n_spk, n_accents=max(len(self.accents), 2),
                             version=self.conf.get("version") or "fastspeech2",
                             fused_mrf=fused_vocoder)
        model.load_state_dict(model_state_dict(ckpt_path))
        self.half = half
        self.dtype = torch.bfloat16 if half else torch.float32
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self._upsample = self.model.upsample_factor

    def _speaker_ids(self, speaker: Union[str, int], B: int) -> torch.Tensor:
        return torch.full((B,), _label(self.speakers, speaker), dtype=torch.int64,
                          device=self.device)

    def _inputs(self, texts: Sequence[str]):
        ids, lens, _ = self.encode_texts(texts)
        return (torch.as_tensor(ids, device=self.device),
                torch.as_tensor(lens, device=self.device))

    def __call__(self, texts: Sequence[str], speaker: Union[str, int] = 0,
                 accent: Union[str, int] = 0) -> List[np.ndarray]:
        """Synthesize a batch of sentences -> list of float32 waveforms.
        JOINT's CVAE takes ``accent`` and a reference mel of 64 zero frames,
        as ``TwoStageTTS`` does by default (the JAX JOINT call passes
        neither; ROADMAP.md section 3); JETS and VITS2 read no accent."""
        ids, lens = self._inputs(texts)
        B = len(texts)
        sids = self._speaker_ids(speaker, B)
        if self.model_type in ("jets", "vits2"):
            wav, wav_lens = self.model.inference(sids, ids, lens, self.max_mel_frames)
        else:
            aids = torch.full((B,), _label(self.accents, accent), dtype=torch.int64,
                              device=self.device)
            wav, wav_lens = self.model.inference(
                sids, ids, lens, self.max_mel_frames,
                feats=_reference_feats(B, None, self.n_mels, self.dtype, self.device),
                aids=aids)
        wav = wav.float().cpu().numpy()
        wav_lens = wav_lens.cpu().numpy()
        return [wav[i, : int(wav_lens[i])] for i in range(B)]

    def stream_wav(self, text: str, speaker: Union[str, int] = 0,
                   chunk_frames: int = 64,
                   context_frames: int = 32) -> Iterator[np.ndarray]:
        """Yield waveform chunks for ONE utterance (JETS, VITS2): the
        acoustic half (VITS2: up to the flow's latents) runs once, the
        decoder decodes fixed-size windows with receptive-field context
        (``infer/streaming.py``), so the first audio arrives after one
        chunk. JOINT raises ``NotImplementedError``, as in the JAX
        package."""
        if self.model_type not in ("jets", "vits2"):
            raise NotImplementedError(
                "chunked streaming decode is wired for JETS/VITS2; the "
                "Text2Wav composer decode remains monolithic (use "
                "stream_long for sentence-level streaming)")
        ids, lens = self._inputs([text])
        sids = self._speaker_ids(speaker, 1)
        zs, mel_lens = self.model.inference_hidden(sids, ids, lens, self.max_mel_frames)
        decode = self.model.decode_hidden
        if self.model_type == "vits2":
            def decode(z):
                return self.model.decode_hidden(z, sids)
        yield from _trimmed_stream(decode, zs, self._upsample, int(mel_lens[0]),
                                   chunk_frames, context_frames)


def _reference_feats(B: int, reference_mel: Optional[np.ndarray], n_mels: int,
                     dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The CVAE's reference mel (B, T, n_mels): zeros (64 frames) unless
    given."""
    if reference_mel is None:
        return torch.zeros(B, 64, n_mels, dtype=dtype, device=device)
    ref = torch.as_tensor(np.asarray(reference_mel), dtype=dtype, device=device)
    return ref[None].expand(B, *ref.shape).contiguous()


def _trimmed_stream(decode, hidden: torch.Tensor, upsample: int, n_frames: int,
                    chunk_frames: int, context_frames: int) -> Iterator[np.ndarray]:
    """``stream_vocoder`` chunks of one utterance, cut at its last real
    frame (``n_frames * upsample`` samples)."""
    from viet_tts_torch.infer.streaming import stream_vocoder

    n_samples = n_frames * upsample
    emitted = 0
    for chunk in stream_vocoder(decode, hidden, upsample, chunk_frames=chunk_frames,
                                context_frames=context_frames):
        want = n_samples - emitted
        if want <= 0:
            break
        out = chunk[0, : min(chunk.shape[1], want)]
        emitted += out.shape[0]
        yield out


def _label(table: Dict[str, int], key: Union[str, int]) -> int:
    """A speaker / accent name or id -> its id (0 for an unknown name)."""
    return int(table.get(key, key if isinstance(key, int) else 0))


class TwoStageTTS(_TTSBase):
    """Acoustic model -> mel -> HiFi-GAN vocoder: ``model_type``
    FASTSPEECH2, ADASPEECH or MATCHA (its ``models.<family>`` section).

    ``fused_vocoder`` routes the vocoder's ch <= 64 stages to kernel K2; a
    FastSpeech2-conformer runs the attention route its config names
    (``flash``: kernels K4 / K5 / K6); the FFT blocks (AdaSpeech, a
    FastSpeech2 with ``block_type: transformer``) and Matcha's attention are
    plain PyTorch. The acoustic model gets the CVAE's reference mel (64 zero
    frames unless one is given), so AdaSpeech takes its acoustic conditions
    from it, as in the JAX package. Matcha solves its ODE in 10 Euler steps
    from zero noise (the JAX API's temperature 0) and denormalises with the
    checkpoint's ``stats.json``, which must hold ``mel_mean`` / ``mel_std``
    (it refuses a checkpoint without them)."""

    def __init__(self, acoustic_path: str, vocoder_path: str,
                 model_type: str = "FASTSPEECH2", max_mel_frames: int = 1008,
                 half: bool = False, fused_vocoder: bool = True,
                 packed_vocoder: Optional[bool] = None,
                 device: Optional[Union[str, torch.device]] = None):
        from viet_tts_torch.models.hifigan import HiFiGANGenerator

        self.model_type = model_type.lower()
        if self.model_type not in ACOUSTIC_FAMILIES:
            raise ValueError(f"unknown two-stage model_type {model_type!r}")
        self.device = resolve_device(device)
        acoustic_ckpt = resolve_checkpoint(acoustic_path)
        vocoder_ckpt = resolve_checkpoint(vocoder_path)
        side = load_sidecars(os.path.dirname(acoustic_ckpt))
        self.conf = side.get("conf") or default_conf()
        self.stats = side.get("stats") or port_config.DEFAULT_STATS
        self.speakers = side.get("speakers") or {}
        self.accents = side.get("accents") or {}
        super().__init__(
            sr=self.conf["audio"]["signal"]["sampling_rate"],
            hop=self.conf["audio"]["stft"]["hop_length"],
        )
        self.max_mel_frames = max_mel_frames
        self.n_mels = self.conf["audio"]["mel"]["channels"]
        acoustic = build_acoustic(NUM_SYMBOLS, self.n_mels, self.conf, self.model_type,
                                  self.stats, n_speakers=max(len(self.speakers), 1),
                                  n_accents=max(len(self.accents), 2))
        acoustic.load_state_dict(model_state_dict(acoustic_ckpt))
        del packed_vocoder  # accepted for the JAX signature (see _resolve_packed)
        vocoder = HiFiGANGenerator.from_config(
            self.n_mels, self.conf["models"].get("hifigan", {}), fused_mrf=fused_vocoder)
        vocoder.load_state_dict(model_state_dict(vocoder_ckpt))
        self.half = half
        self.dtype = torch.bfloat16 if half else torch.float32
        self.acoustic = acoustic.to(device=self.device, dtype=self.dtype).eval()
        self.vocoder = vocoder.to(device=self.device, dtype=self.dtype).eval()

    def _mel(self, texts: Sequence[str], speaker, accent, reference_mel,
             d_control: float, p_control: float, e_control: float):
        ids, lens, _ = self.encode_texts(texts)
        B = len(texts)
        sids = torch.full((B,), _label(self.speakers, speaker), dtype=torch.int64,
                          device=self.device)
        aids = torch.full((B,), _label(self.accents, accent), dtype=torch.int64,
                          device=self.device)
        mel, mel_lens, _ = self.acoustic.inference(
            sids, torch.as_tensor(ids, device=self.device),
            torch.as_tensor(lens, device=self.device), self.max_mel_frames,
            feats=_reference_feats(B, reference_mel, self.n_mels, self.dtype, self.device),
            aids=aids, d_control=d_control,
            p_control=p_control, e_control=e_control)
        return mel, mel_lens

    def _vocode(self, mel: torch.Tensor) -> torch.Tensor:
        return self.vocoder(mel)[..., 0]

    @torch.no_grad()
    def __call__(self, texts: Sequence[str], speaker: Union[str, int] = 0,
                 accent: Union[str, int] = 0, reference_mel: Optional[np.ndarray] = None,
                 d_control: float = 1.0, p_control: float = 1.0,
                 e_control: float = 1.0) -> List[np.ndarray]:
        """Synthesize a batch of sentences -> list of float32 waveforms."""
        mel, mel_lens = self._mel(texts, speaker, accent, reference_mel, d_control,
                                  p_control, e_control)
        wav = self._vocode(mel).float().cpu().numpy()
        mel_lens = mel_lens.cpu().numpy()
        return [wav[i, : int(mel_lens[i]) * self.hop] for i in range(len(texts))]

    @torch.no_grad()
    def stream_wav(self, text: str, speaker: Union[str, int] = 0,
                   accent: Union[str, int] = 0, chunk_frames: int = 64,
                   context_frames: int = 32) -> Iterator[np.ndarray]:
        """Yield waveform chunks for ONE utterance: the acoustic stage runs
        once, the vocoder decodes fixed-size mel windows with
        receptive-field context (``infer/streaming.py``)."""
        mel, mel_lens = self._mel([text], speaker, accent, None, 1.0, 1.0, 1.0)
        yield from _trimmed_stream(self._vocode, mel, self.hop, int(mel_lens[0]),
                                   chunk_frames, context_frames)

"""Minimal HTTP serving front-end (stdlib only) over ``OneStageTTS`` or
``TwoStageTTS``.

Counterpart of ``viet_tts_tpu/infer/server.py``:

    python -m viet_tts_torch.infer.server -c ckpt_dir --port 8000
    python -m viet_tts_torch.infer.server --model_type JOINT -c text2wav_ckpt_dir
    python -m viet_tts_torch.infer.server --model_type VITS2 -c vits2_ckpt_dir
    python -m viet_tts_torch.infer.server --model_type FASTSPEECH2 \
        -a acoustic_ckpt_dir -v vocoder_ckpt_dir --max_mel_frames 2048
    python -m viet_tts_torch.infer.server --model_type ADASPEECH \
        -a adaspeech_ckpt_dir -v vocoder_ckpt_dir
    python -m viet_tts_torch.infer.server --model_type MATCHA \
        -a matcha_ckpt_dir -v vocoder_ckpt_dir

API:
    GET  /health               -> {"status": "ok", "model": "..."}
    POST /synthesize           -> audio/wav bytes
         body: {"text": "...", "speaker": 0}
    POST /synthesize_stream    -> chunked 16-bit PCM (no RIFF header);
         audio bytes flow as the vocoder decodes (``stream_wav``); a
         backend with no streaming decode (JOINT) answers 501.

Requests are serialized through one lock: synthesis occupies the card, and
batching beyond one request belongs to the bucketed ``__call__`` API. The
server is threaded for health checks and keep-alive.
"""

from __future__ import annotations

import io
import itertools
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def wav_bytes(wave: np.ndarray, sr: int) -> bytes:
    """float32 (-1, 1) -> 16-bit PCM RIFF/WAVE bytes."""
    pcm = (np.clip(wave, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(pcm)))
    buf.write(b"WAVEfmt ")
    buf.write(struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16))
    buf.write(b"data")
    buf.write(struct.pack("<I", len(pcm)))
    buf.write(pcm)
    return buf.getvalue()


def make_handler(tts, model_name: str):
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok", "model": model_name})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path not in ("/synthesize", "/synthesize_stream"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                text = req["text"]
            except (ValueError, KeyError) as e:
                self._json(400, {"error": f"bad request: {e!r}"})
                return
            if self.path == "/synthesize_stream":
                self._stream(text, req)
                return
            try:
                with lock:
                    waves = tts([text], speaker=req.get("speaker", 0))
                body = wav_bytes(waves[0], tts.sr)
            except Exception as e:  # surface synthesis errors as 500 JSON
                self._json(500, {"error": repr(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream(self, text: str, req: dict):
            started = False
            try:
                with lock:
                    # draw the first chunk before committing the response so
                    # a synthesis error can still return clean JSON
                    gen = tts.stream_wav(text, speaker=req.get("speaker", 0))
                    first = next(gen)
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/L16; rate=%d" % tts.sr)
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    started = True
                    for wave in itertools.chain([first], gen):
                        pcm = (np.clip(wave, -1.0, 1.0)
                               * 32767.0).astype("<i2").tobytes()
                        self.wfile.write(f"{len(pcm):x}\r\n".encode() + pcm + b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
            except NotImplementedError as e:  # a backend with no streaming decode
                self._json(501, {"error": repr(e)})
            except Exception as e:
                if started:  # headers gone; just drop the connection
                    self.close_connection = True
                else:
                    self._json(500, {"error": repr(e)})

    return Handler


def serve(tts, host: str = "127.0.0.1", port: int = 8000,
          model_name: str = "tts") -> ThreadingHTTPServer:
    """Start the server on a daemon thread; returns the server object (call
    ``.shutdown()`` and ``.server_close()`` to stop it)."""
    httpd = ThreadingHTTPServer((host, port), make_handler(tts, model_name))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def build_backend(argv=None):
    """Parse the command line (``argv``, default ``sys.argv``) and build its
    ``OneStageTTS`` (JETS, VITS2, JOINT: ``-c``) or ``TwoStageTTS``
    (FASTSPEECH2, ADASPEECH, MATCHA: ``-a``, ``-v``); returns (tts, args)."""
    import argparse

    from viet_tts_torch.infer.api import OneStageTTS, TwoStageTTS

    ap = argparse.ArgumentParser(description="HTTP TTS serving endpoint (PyTorch)")
    ap.add_argument("--model_type", default="JETS")
    ap.add_argument("-c", "--checkpoint", default=None,
                    help="one-stage (JETS, VITS2, JOINT) checkpoint directory")
    ap.add_argument("-a", "--acoustic_checkpoint", default=None,
                    help="two-stage acoustic (FASTSPEECH2, ADASPEECH, MATCHA) checkpoint "
                         "directory")
    ap.add_argument("-v", "--vocoder_checkpoint", default=None,
                    help="two-stage HiFi-GAN checkpoint directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--half", action="store_true")
    ap.add_argument("--max_mel_frames", type=int, default=1008)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.model_type.upper() in ("FASTSPEECH2", "ADASPEECH", "MATCHA"):
        if not (args.acoustic_checkpoint and args.vocoder_checkpoint):
            ap.error(f"--model_type {args.model_type} needs -a and -v")
        tts = TwoStageTTS(args.acoustic_checkpoint, args.vocoder_checkpoint,
                          model_type=args.model_type, half=args.half,
                          max_mel_frames=args.max_mel_frames, device=args.device)
    else:
        if not args.checkpoint:
            ap.error(f"--model_type {args.model_type} needs -c")
        tts = OneStageTTS(args.checkpoint, model_type=args.model_type,
                          half=args.half, max_mel_frames=args.max_mel_frames,
                          device=args.device)
    return tts, args


def _main(argv=None):
    tts, args = build_backend(argv)
    httpd = ThreadingHTTPServer((args.host, args.port),
                                make_handler(tts, args.model_type))
    print(f"serving {args.model_type} on http://{args.host}:{args.port}")
    httpd.serve_forever()


if __name__ == "__main__":
    _main()

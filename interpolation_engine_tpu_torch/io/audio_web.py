"""Audio-over-HTTP streaming server.

The reference declares an ``audio_web`` module whose source is absent from
the repository (reference: rust-project/src/main.rs:10 and
runtime.rs:430-433, :2246-2261 use it; its STATUS notes describe an HTTP
server streaming WAV with keepalive silence). This is a from-scratch
asyncio implementation of that documented capability:

* ``GET /`` returns a minimal HTML page with an ``<audio>`` element;
* ``GET /audio`` streams an endless chunked WAV: a PCM s16le header with a
  huge declared length, then broadcast TTS audio, padded with silence
  whenever no audio is pending so browsers keep the connection alive;
* TTS pipelines call :meth:`AudioWebServer.broadcast` with raw PCM instead
  of piping to ``pw-play``; :meth:`wait_for_idle` lets ``speak`` finish
  before the program continues.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Optional

_KEEPALIVE_INTERVAL = 0.25  # seconds of silence per keepalive chunk


def wav_header(rate: int, channels: int, bits: int = 16) -> bytes:
    """A streaming-friendly WAV header with a maximal data length."""
    byte_rate = rate * channels * bits // 8
    block_align = channels * bits // 8
    data_len = 0x7FFFFFFF - 44
    return b"".join([
        b"RIFF", struct.pack("<I", data_len + 36), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, channels, rate, byte_rate,
                             block_align, bits),
        b"data", struct.pack("<I", data_len),
    ])


class AudioWebServer:
    def __init__(self, port: int = 0, rate: int = 22050, channels: int = 1):
        self.port = port
        self.rate = rate
        self.channels = channels
        self._server: Optional[asyncio.AbstractServer] = None
        self._clients: set[asyncio.Queue] = set()
        self._pending = 0
        self._idle = asyncio.Event()
        self._idle.set()

    # ---- lifecycle ----------------------------------------------------------

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle, "0.0.0.0", self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self):
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        for q in list(self._clients):
            q.put_nowait(None)

    # ---- broadcast ------------------------------------------------------------

    def configure(self, rate: int, channels: int):
        """Adopt the voice's sample rate before the first client connects."""
        self.rate = rate
        self.channels = channels

    def broadcast(self, pcm: bytes):
        """Queue raw PCM for every connected client."""
        if not pcm:
            return
        self._pending += len(pcm)
        self._idle.clear()
        for q in list(self._clients):
            q.put_nowait(pcm)
        if not self._clients:
            self._pending = 0
            self._idle.set()

    async def wait_for_idle(self):
        """Block until all broadcast audio has been drained to clients."""
        await self._idle.wait()

    # ---- http ------------------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        try:
            request_line = await reader.readline()
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            path = request_line.split(b" ")[1].decode("latin-1") \
                if len(request_line.split(b" ")) > 1 else "/"

            if path == "/audio":
                await self._serve_audio(writer)
            else:
                body = (b"<!doctype html><title>TTS</title>"
                        b"<audio controls autoplay src=\"/audio\"></audio>")
                writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/html\r\n"
                             + f"Content-Length: {len(body)}\r\n\r\n".encode()
                             + body)
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError, IndexError):
            pass
        finally:
            writer.close()

    async def _serve_audio(self, writer: asyncio.StreamWriter):
        queue: asyncio.Queue = asyncio.Queue()
        self._clients.add(queue)

        def chunk(data: bytes) -> bytes:
            return f"{len(data):x}\r\n".encode() + data + b"\r\n"

        silence_bytes = int(self.rate * self.channels * 2
                            * _KEEPALIVE_INTERVAL)
        try:
            writer.write(b"HTTP/1.1 200 OK\r\n"
                         b"Content-Type: audio/wav\r\n"
                         b"Cache-Control: no-store\r\n"
                         b"Transfer-Encoding: chunked\r\n\r\n")
            writer.write(chunk(wav_header(self.rate, self.channels)))
            await writer.drain()
            while True:
                try:
                    data = await asyncio.wait_for(
                        queue.get(), timeout=_KEEPALIVE_INTERVAL)
                except asyncio.TimeoutError:
                    # keepalive silence so players don't stall/buffer out
                    writer.write(chunk(b"\x00" * silence_bytes))
                    await writer.drain()
                    continue
                if data is None:
                    break
                writer.write(chunk(data))
                await writer.drain()
                self._pending = max(0, self._pending - len(data))
                if self._pending == 0:
                    self._idle.set()
        finally:
            self._clients.discard(queue)


_current: dict = {"server": None}


def get_or_start(port: int = 0) -> AudioWebServer:
    """Process-wide lazy server (mirrors the reference's get_or_start use)."""
    if _current["server"] is None:
        server = AudioWebServer(port=port)
        loop = asyncio.get_event_loop()
        loop.run_until_complete(server.start()) if not loop.is_running() \
            else asyncio.ensure_future(server.start())
        _current["server"] = server
    return _current["server"]

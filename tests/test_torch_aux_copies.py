"""The port's copies of ``tools/show_tokens.py`` and ``io/audio_web.py``
under the JAX package's own tests of them: ``tests/test_show_tokens.py``'s
three tests with its ``main`` and ``stream_tokens`` swapped for the port's,
and ``tests/test_aux_subsystems.py``'s ``test_audio_web_streams_wav`` with
the module it imports swapped for the port's."""

import sys

import pytest

import test_aux_subsystems
import test_show_tokens

from interpolation_engine_tpu_torch.io import audio_web
from interpolation_engine_tpu_torch.tools import show_tokens


def test_the_copy_streams_through_the_ports_chat_client():
    assert show_tokens.get_client.__module__ == \
        "interpolation_engine_tpu_torch.chat.service"


def test_show_tokens_help_names_the_ports_script(capsys):
    with pytest.raises(SystemExit):
        show_tokens.main(["--help"])
    assert capsys.readouterr().out.startswith(
        "usage: show-tokenization-tpu-torch ")


@pytest.mark.parametrize("name", ["test_show_tokens_alternating_colors",
                                  "test_show_tokens_mismatch_warning",
                                  "test_show_tokens_cli_entry"])
def test_show_tokens_copy(name, monkeypatch, capsys):
    monkeypatch.setattr(test_show_tokens, "main", show_tokens.main)
    monkeypatch.setattr(test_show_tokens, "stream_tokens",
                        show_tokens.stream_tokens)
    getattr(test_show_tokens, name)(capsys)


def test_audio_web_copy_streams_wav(monkeypatch):
    started = []

    class Server(audio_web.AudioWebServer):
        async def start(self):
            started.append(self)
            return await super().start()

    monkeypatch.setattr(audio_web, "AudioWebServer", Server)
    monkeypatch.setitem(sys.modules, "interpolation_engine_tpu.io.audio_web",
                        audio_web)
    test_aux_subsystems.test_audio_web_streams_wav()
    assert len(started) == 1

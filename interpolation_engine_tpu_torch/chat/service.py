"""Chat orchestration: streaming + filtering + TTS + structured choices.

Behavioral contract (reference: interpolation_engine.py:602-846):

* start/stop extraction filter and hide filter run per streamed delta;
  visible fragments go to the IO manager and (optionally) a live TTS pipe.
* ``choices_list`` restricts the model output via a JSON-schema
  ``response_format`` (an extra user message carries the schema prompt);
  the raw JSON response is validated and the chosen string returned.
* ``finish_reason == 'length'`` → an out-of-context modal inviting the user
  to save and retry with a bigger context.
* Returns ``([stripped outputs], visual_output)``.
"""

from __future__ import annotations

import json

from ..core.context import log
from ..core.filters import InvertedFilter, OutputFilter
from ..io import tts as tts_mod
from .client import ChatClient, ChatError, OutOfContextError

# Client cache: recreating a connection-bound client costs 100-200 ms in the
# reference (interpolation_engine.py:649), so cache per (api_url, api_key).
_client_cache: dict[tuple[str, str], ChatClient] = {}


def get_client(api_url: str, api_key: str) -> ChatClient:
    key = (api_url, api_key)
    client = _client_cache.get(key)
    if client is None:
        client = ChatClient(api_url, api_key)
        _client_cache[key] = client
    return client


def choice_schema(choices_list: list[str]) -> dict:
    """JSON schema for a single restricted choice (pydantic-shaped)."""
    return {
        "properties": {
            "choice": {"enum": list(choices_list), "title": "Choice"},
        },
        "required": ["choice"],
        "title": "Choice",
        "type": "object",
    }


def log_messages(messages):
    log("\n----------------------------MESSAGES--------------------------")
    log("\n\n".join(f"{m['role'].upper()}\n{m['content']}" for m in messages))
    log("\n--------------------------------------------------------------")


async def run_chat(
    io,
    messages,
    completion_args,
    start_str="",
    stop_str="",
    hide_start_str="",
    hide_stop_str="",
    n_outputs=1,
    shown=True,
    choices_list=None,
    voice_path=None,
    voice_speaker=None,
    api_url="http://localhost:8080",
    api_key="unused",
    extra_body=None,
):
    assert bool(start_str) == bool(stop_str), (
        "You can either set both start_str and stop_str or none. Right now you "
        "have only set one of them.")
    if choices_list is not None:
        assert start_str == stop_str == "", (
            "Filtering is not supported when using choices.")
        assert n_outputs == 1, "Multiple outputs not supported when using choices."

    client = get_client(api_url, api_key)

    async def out_of_context_message():
        log("WARNING: Ran out of context length, generation stopped short.")
        await io.select_index(
            [],
            "Generation exceeded context length! Instead of crashing, this "
            "message is being shown so that you can save and try to increase "
            "your context length before loading. Loading this save will restart "
            "the generation.")

    raw = ""
    visual_output = ""
    log(f"🛈  Starting generation with these completion_args: {completion_args}")

    piper = None
    tts_writer = None
    if voice_path:
        piper = tts_mod.start_pipeline(voice_path, voice_speaker)
        tts_writer = tts_mod.TtsWriter(piper)

    body = dict(extra_body or {})  # top-level merge (llama.cpp grammar et al.)
    body.update(completion_args)
    body["messages"] = messages
    body["stream"] = True

    ran_out_of_context = False
    outputs: list[str] = []
    import os as _os
    # batch fast path: collect the raw stream, then ONE device kernel call
    # extracts outputs + visual text (ops/filter_kernel.py) instead of a
    # per-chunk Python state machine per instance. Token-granular filter
    # semantics (the chunk->0 limit); no live display/TTS incrementality,
    # so it stays opt-in and off for voiced or choice chats.
    device_filters = (_os.environ.get("IE_TPU_DEVICE_FILTERS") == "1"
                      and choices_list is None and not voice_path)
    try:
        if device_filters:
            async for delta in client.stream_chat(body):
                if delta.finish_reason == "length":
                    ran_out_of_context = True
                if delta.content is None:
                    continue
                raw += delta.content
            from ..ops.filter_kernel import filter_chat_host
            outputs, visual_output = filter_chat_host(
                raw, start_str, stop_str, hide_start_str, hide_stop_str,
                n_outputs > 1)
            if shown and visual_output:
                await io.write(visual_output)
            elif not shown:
                visual_output = ""
        elif choices_list is None:
            hide = InvertedFilter(hide_start_str, hide_stop_str)
            extract = OutputFilter(start_str, stop_str,
                                   enumerate_outputs=n_outputs > 1)
            outputs = extract.outputs
            async for delta in client.stream_chat(body):
                if delta.finish_reason == "length":
                    ran_out_of_context = True
                if delta.content is None:
                    continue
                raw += delta.content
                fragment = extract(delta.content)
                visual_fragment = hide(fragment)
                if shown:
                    await io.write(visual_fragment)
                    visual_output += visual_fragment
                if tts_writer and visual_fragment:
                    tts_writer.write(visual_fragment)
        else:
            schema = json.dumps(choice_schema(choices_list))
            schema_prompt = (
                f"Respond only with a valid JSON object conforming to this "
                f"schema: {schema}. Do not add any additional text.")
            body["messages"] = list(messages) + [
                {"role": "user", "content": schema_prompt}]
            body["response_format"] = {"type": "json_schema", "json_schema": schema}
            async for delta in client.stream_chat(body):
                if delta.finish_reason == "length":
                    ran_out_of_context = True
                if delta.content is None:
                    continue
                raw += delta.content
                if shown:
                    await io.write(delta.content)
                    visual_output += delta.content
                if tts_writer:
                    tts_writer.write(delta.content)
            parsed = json.loads(raw)
            choice = parsed.get("choice") if isinstance(parsed, dict) else None
            if choice not in choices_list:
                raise ChatError(
                    f"model response {raw!r} is not one of the permitted choices")
            outputs = [choice]
    except OutOfContextError:
        log_messages(messages + [{"role": "assistant", "content": raw}])
        await out_of_context_message()
        raise
    except BaseException:
        log_messages(messages + [{"role": "assistant", "content": raw}])
        if voice_path:
            tts_mod.stop_current_tts()
        raise

    if tts_writer:
        tts_writer.flush()

    if ran_out_of_context:
        await out_of_context_message()

    log_messages(messages + [{"role": "assistant", "content": raw}])
    return [o.strip() for o in outputs], visual_output

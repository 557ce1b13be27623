"""`show-tokenization-tpu-torch` — visualize a model's token boundaries.

Capability parity with the reference's `show-tokenization` console script
(reference: src/interpolation_engine/show_tokens.py:6-57): ask an
OpenAI-compatible server to echo a text verbatim with streaming on; each
streamed delta is one token, so alternating the display color per delta
shows the tokenization. A trailing warning appears if the echo diverged
from the input.
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from ..chat.service import get_client

_COLORS = ["\033[48;5;24m", "\033[48;5;88m"]
_RESET = "\033[0m"


async def stream_tokens(text: str, model: str, api_url: str, api_key: str):
    client = get_client(api_url, api_key)
    body = {
        "model": model,
        "stream": True,
        "temperature": 0,
        "messages": [
            {"role": "system",
             "content": "Repeat the user's message exactly, character for "
                        "character. Output nothing else."},
            {"role": "user", "content": text},
        ],
    }
    echoed = ""
    i = 0
    async for delta in client.stream_chat(body):
        if delta.content:
            color = _COLORS[i % len(_COLORS)]
            sys.stdout.write(f"{color}{delta.content}{_RESET}")
            sys.stdout.flush()
            echoed += delta.content
            i += 1
    print()
    if echoed.strip() != text.strip():
        print("WARNING: the echoed text does not match the input — token "
              "boundaries above may be unreliable.", file=sys.stderr)
    print(f"({i} tokens)", file=sys.stderr)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="show-tokenization-tpu-torch",
        description="Visualize model token boundaries by streaming an echo.")
    parser.add_argument("text", nargs="?",
                        help="Text to tokenize (reads stdin if omitted).")
    parser.add_argument("--model", default="default")
    parser.add_argument("--api-url", default="http://localhost:8080")
    parser.add_argument("--api-key", default="unused")
    args = parser.parse_args(argv)

    text = args.text if args.text is not None else sys.stdin.read()
    asyncio.run(stream_tokens(text, args.model, args.api_url, args.api_key))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Static capacities of the device VM (shapes are compile-time constants).

Everything on the device is fixed-shape: strings live in padded uint8
buffers, the insert store has a fixed number of slots, etc. Overflowing any
capacity parks the instance for host rescue (status=OVERFLOW) rather than
corrupting state. Capacities are tuned per batch size by the driver.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class VMConfig:
    max_str: int = 512        # working string buffer length (bytes)
    max_key: int = 64         # max insert-key length (bytes)
    n_slots: int = 48         # insert table slots
    arena_size: int = 8192    # per-instance byte arena
    pool_size: int = 96       # list-element pool entries
    out_size: int = 4096      # output buffer bytes
    max_loops: int = 8        # concurrently-nested for-loop counters
    max_subst: int = 16       # interpolation substitutions per string
    max_stars: int = 7        # wildcard '*' groups per pattern
    max_fix: int = 24         # replace_map repeat_until_done iterations
    max_list: int = 48        # max elements manipulated per list op
    max_threads: int = 8      # parallel_wait/race thread lanes per instance

    def smaller(self, **kw):
        from dataclasses import replace
        return replace(self, **kw)


DEFAULT = VMConfig()

# Environment variables the port reads:
#   IE_TPU_TURBO=1|0           — force/skip the turbo engine in the CLI
#                                (vm/driver.py run_program_on_device)
#   IE_TPU_DEVICE_FILTERS=1    — chat/service.py filters a whole stream in
#     one call of the CUDA chat-filter kernel (ops/filter_kernel.py) for
#     chats that are neither voiced nor choices; off by default, because
#     the incremental host filters show the text while it streams
#   IE_TPU_FAST_RING=0         — every park through the exact host ring
#                                (vm/turbo.py, read when an engine is made)
#   IE_TPU_NO_NATIVE=1         — the Python JSON5 parser (json5/)

# Instance status codes
RUNNING = 0
DONE = 1
PARKED = 2    # waiting for host IO (park_kind says why)
ERROR = 3
OVERFLOW = 4  # capacity exceeded; host rescue required

# Park kinds (host ring request types)
PARK_USER_INPUT = 1
PARK_USER_CHOICE = 2
PARK_AWAIT_INSERT = 3
PARK_CHAT = 4
PARK_WRITE = 5
PARK_SPEAK = 6
PARK_SHOW_INSERTS = 7
PARK_SLEEP = 8
PARK_HOST_OP = 9   # anything the device lowers to "run this task on host"
PARK_THREADS = 10  # every live parallel-block thread is awaiting host IO

# Thread-lane states (parallel_wait/parallel_race device threads; the lane
# currently executing is tracked by VMInstance.cur_tid)
T_FREE = 0    # lane unused
T_NEW = 1     # spawned, never run (asyncio: scheduled, first slice pending)
T_READY = 2   # resumed — host IO completed, lane can continue
T_WAIT = 3    # parked on host IO (tpark_kind/tpark_arg say why/where)
T_DONE = 4    # subtask body completed

# par_mode values
PM_NONE = 0
PM_WAIT = 1   # parallel_wait (asyncio.gather)
PM_RACE = 2   # parallel_race (asyncio.wait FIRST_COMPLETED)
PM_DRAIN = 3  # race finished; never-run lanes get their first slice, then
              # everything pending is cancelled (asyncio scheduling parity)

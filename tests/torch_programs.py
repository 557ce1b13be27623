"""Turbo programs shared by the PyTorch port's tests and ``chip_smoke.py``:
scalar ones, then list and parallel-lane ones. Plain text, no imports, so
the card-side script can use them without JAX."""

# the JAX package's scalar turbo tests (tests/test_turbo.py)
COPY_TYPES = """
{
    default_state: {order_index: 1, inserts: {n: -42, s: 'str val'}},
    order: [
        {cmd:'set', item:'{n}', output_name:'n2'},
        {cmd:'set', item:'{s}', output_name:'s2'},
        {cmd:'math', input:'{n2} * 2', output_name:'d'},
        {cmd:'print', text:'d={d} s2={s2} n2={n2}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

DELETE_CLEAR = """
{
    default_state: {order_index: 1, inserts: {aa: 1, ab: 2, zz: 'k'}},
    order: [
        {cmd:'print', text:'before'},
        {cmd:'clear'},
        {cmd:'delete', wildcards:['a*']},
        {cmd:'print', text:'kept {zz}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

DIGIT_MATH = """
{
    default_state: {order_index: 1, inserts: {d: '84', n: 7}},
    order: [
        {cmd:'math', input:'{d} / 2 + {n} - -3', output_name:'r'},
        {cmd:'math', input:'max(1, {r}, 9) + min({n}, 2)', output_name:'m'},
        {cmd:'math', input:'sign(3 - {n})', output_name:'sg'},
        {cmd:'print', text:'{r}/{m}/{sg}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

MISSING_KEY = """
{
    default_state: {order_index: 1, inserts: {ghost: 1}},
    order: [
        {cmd:'delete', wildcards:['ghost']},
        {cmd:'print', text:'v={ghost}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

NULL_ROUTE = """
{
    default_state: {order_index: 1, inserts: {k: 'x'}},
    order: [
        {cmd:'delete', wildcards:['k']},
        {cmd:'goto_map', text:'{k}', target_maps:[
            {'x': '@a'}, {'NULL': '@b'},
        ]},
        {cmd:'label', name:'@a'},
        {cmd:'print', text:'A'},
        {cmd:'goto', name:'@end'},
        {cmd:'label', name:'@b'},
        {cmd:'print', text:'B'},
        {cmd:'label', name:'@end'},
    ],
    named_tasks: {}, save_states: {},
}
"""

NEWLINE_ROUTE = """
{
    default_state: {order_index: 1, inserts: {}},
    order: [
        {cmd:'set', item:'hello\\n', output_name:'v'},
        {cmd:'goto_map', text:'{v}', target_maps:[
            {'%(key)s': '@yes'},
            {'*': '@no'},
        ]},
        {cmd:'label', name:'@yes'},
        {cmd:'print', text:'matched-early'},
        {cmd:'goto', name:'@end'},
        {cmd:'label', name:'@no'},
        {cmd:'print', text:'fell-to-star'},
        {cmd:'label', name:'@end'},
    ],
    named_tasks: {}, save_states: {},
}
"""

FOR_LOOP = """
{
    default_state: {order_index: 1, inserts: {total: 0}},
    order: [
        {cmd:'for', name_list_map:{x: ['1','2','3'], y: ['10','20','30']},
         tasks:[
            {cmd:'math', input:'{total} + {x} * {y}', output_name:'total'},
            {cmd:'print', text:'{x}*{y};'},
        ]},
        {cmd:'print', text:'total={total} last={x}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

FOR_MIXED = """
{
    default_state: {order_index: 1, inserts: {}},
    order: [
        {cmd:'for', name_list_map:{item: ['alpha', 7, 'gamma']},
         tasks:[
            {cmd:'set', item:'<{item}>', output_name:'seen'},
        ]},
        {cmd:'print', text:'{seen}!{item}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

FOR_NESTED = """
{
    default_state: {order_index: 1, inserts: {}},
    order: [
        {cmd:'for', name_list_map:{a: ['1', '2']}, tasks:[
            {cmd:'for', name_list_map:{b: ['x', 'y']}, tasks:[
                {cmd:'print', text:'{a}{b} '},
            ]},
        ]},
        {cmd:'print', text:'.'},
    ],
    named_tasks: {}, save_states: {},
}
"""

# hazards of a hand port of the TPU kernel, one program each
FLOOR_DIV_MOD = """
{
    default_state: {order_index: 1, inserts: {a: -7, b: 3, c: -8}},
    order: [
        {cmd:'math', input:'{a} % {b}', output_name:'r1'},
        {cmd:'math', input:'7 % -3', output_name:'r2'},
        {cmd:'math', input:'{a} % -3', output_name:'r3'},
        {cmd:'math', input:'{c} / 2', output_name:'q1'},
        {cmd:'math', input:'{c} / -4', output_name:'q2'},
        {cmd:'print', text:'{r1} {r2} {r3} {q1} {q2}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

# an inexact division parks, and the host raises its exact error
INEXACT_DIV = """
{
    default_state: {order_index: 1, inserts: {a: -7}},
    order: [
        {cmd:'math', input:'{a} / 2', output_name:'q'},
        {cmd:'print', text:'{q}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

# int32 wraparound: the TPU kernel wraps add/sub/mul at 32 bits where the
# host's Python ints grow, so this one is held against the JAX engine only
INT32_OVERFLOW = """
{
    default_state: {order_index: 1, inserts: {big: 2147483647, m: -2147483647}},
    order: [
        {cmd:'math', input:'{big} + 1', output_name:'o1'},
        {cmd:'math', input:'{m} - 2', output_name:'o2'},
        {cmd:'math', input:'{big} * {big}', output_name:'o3'},
        {cmd:'math', input:'0 - {o1}', output_name:'o4'},
        {cmd:'print', text:'{o1} {o2} {o3} {o4}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

INT32_MIN_PRINT = """
{
    default_state: {order_index: 1, inserts: {m: -2147483647, z: 0}},
    order: [
        {cmd:'math', input:'{m} - 1', output_name:'lo'},
        {cmd:'set', item:'[{lo}|{z}|{m}]', output_name:'txt'},
        {cmd:'print', text:'{txt} {lo}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

PARSE_DIGITS = """
{
    default_state: {order_index: 1, inserts:
        {nine: '-999999999', ten: '1234567890', t: '+017', bad: '12a'}},
    order: [
        {cmd:'math', input:'{nine} + {t}', output_name:'p9'},
        {cmd:'math', input:'{ten} + 1', output_name:'p10'},
        {cmd:'print', text:'{p9} {p10}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

BRACE_IN_HOLE = """
{
    default_state: {order_index: 1, inserts: {v: 'a\\\\{b\\\\}c', w: 'plain'}},
    order: [
        {cmd:'print', text:'<{w}>'},
        {cmd:'print', text:'<{v}>'},
        {cmd:'set', item:'{w}+{w}', output_name:'ww'},
        {cmd:'print', text:'{ww}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

OUTPUT_OVERFLOW = """
{
    default_state: {order_index: 1, inserts: {i: 0}},
    order: [
        {cmd:'label', name:'@loop'},
        {cmd:'math', input:'{i} + 1', output_name:'i'},
        {cmd:'print', text:'line {i} of text;'},
        {cmd:'goto_map', text:'{i}', target_maps:[
            {'20': '@end'}, {'*': '@loop'}]},
        {cmd:'label', name:'@end'},
        {cmd:'print', text:'done'},
    ],
    named_tasks: {}, save_states: {},
}
"""

SINGLE_HOLE_INT = """
{
    default_state: {order_index: 1, inserts: {n: 5}},
    order: [
        {cmd:'print', text:'n is '},
        {cmd:'print', text:'{n}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

INT_DISPATCH = """
{
    default_state: {order_index: 1, inserts: {i: 0}},
    order: [
        {cmd:'label', name:'@loop'},
        {cmd:'math', input:'{i} + 1', output_name:'i'},
        {cmd:'goto_map', text:'{i}', target_maps:[
            {'01': '@never'}, {'002': '@never'}, {'-1': '@never'},
            {'3': '@three'},
            {'*': '@loop'}]},
        {cmd:'label', name:'@never'},
        {cmd:'print', text:'wrong {i}'},
        {cmd:'goto', name:'@end'},
        {cmd:'label', name:'@three'},
        {cmd:'print', text:'three {i}'},
        {cmd:'label', name:'@end'},
    ],
    named_tasks: {}, save_states: {},
}
"""

AWAIT_READY = """
{
    default_state: {order_index: 1, inserts: {k: 'here'}},
    order: [
        {cmd:'await_insert', name:'k'},
        {cmd:'print', text:'got {k}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

AWAIT_NOT_READY = """
{
    default_state: {order_index: 1, inserts: {}},
    order: [
        {cmd:'print', text:'waiting'},
        {cmd:'await_insert', name:'late'},
        {cmd:'set', item:'x', output_name:'late'},
    ],
    named_tasks: {}, save_states: {},
}
"""

USER_INPUT = """
{
    default_state: {order_index: 1, inserts: {}},
    order: [
        {cmd:'print', text:'hi '},
        {cmd:'user_input', prompt:'name?', output_name:'name'},
        {cmd:'print', text:'hello {name}!'},
    ],
    named_tasks: {}, save_states: {},
}
"""

# list ops and parallel thread lanes (the JAX package's tests/test_turbo.py)
LIST_SPINE = """
{
    default_state: {order_index: 1, inserts: {hist: ['a','b'], n: 0}},
    order: [
        {cmd:'list_append', list:'{hist}', item:'c-{n}', output_name:'hist'},
        {cmd:'math', input:'length(hist)', output_name:'n'},
        {cmd:'list_index', list:'{hist}', index:-1, output_name:'last'},
        {cmd:'list_slice', list:'{hist}', from_index:1,
         to_index:'{n} - 1', output_name:'head'},
        {cmd:'list_join', list:'{head}', before:'[', between:',',
         after:']', output_name:'joined'},
        {cmd:'list_remove', list:'{hist}', item:'b', output_name:'hist2'},
        {cmd:'list_concat', lists:['{head}','{hist2}'], output_name:'cat'},
        {cmd:'for', name_list_map:{e:'{hist}'}, tasks:[
            {cmd:'print', text:'<{e}>'},
        ]},
        {cmd:'print', text:'{joined} {last} {hist} {cat}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

LIST_EDGES = """
{
    default_state: {order_index: 1, inserts: {l: [3,1,'x']}},
    order: [
        {cmd:'list_slice', list:'{l}', from_index:1, to_index:0,
         output_name:'s0'},
        {cmd:'list_slice', list:'{l}', from_index:-2, to_index:9,
         output_name:'s1'},
        {cmd:'list_slice', list:'{l}', from_index:2, to_index:1,
         output_name:'s2'},
        {cmd:'list_remove', list:'{l}', item:'absent',
         output_name:'r0'},
        {cmd:'list_remove', list:'{l}', item:'x', output_name:'r1'},
        {cmd:'list_join', list:'{s2}', before:'(', between:'-',
         after:')', output_name:'j0'},
        {cmd:'list_index', list:'{l}', index:'3', output_name:'i0'},
        {cmd:'print', text:'{s0}|{s1}|{s2}|{r0}|{r1}|{j0}|{i0}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

FOR_DYNAMIC = """
{
    default_state: {order_index: 1, inserts: {lst: ['a','b',7], n: 0}},
    order: [
        {cmd:'for', name_list_map:{v: '{lst}'}, tasks:[
            {cmd:'print', text:'{v};'},
            {cmd:'math', input:'{n} + 1', output_name:'n'},
        ]},
        {cmd:'print', text:'last={v} n={n}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

PAR_RACE = """
{
    default_state: {order_index: 1, inserts: {x: '(unset)'}},
    order: [
        {cmd:'parallel_%(mode)s', tasks:[
            {cmd:'serial', tasks:[
                {cmd:'set', item:'lane0', output_name:'x'},
                {cmd:'print', text:'[0:{x}]'},
            ]},
            {cmd:'serial', tasks:[
                {cmd:'set', item:'lane1', output_name:'y'},
                {cmd:'print', text:'[1]'},
            ]},
            {cmd:'set', item:'leaf', output_name:'z'},
        ]},
        {cmd:'print', text:'after x={x} y={y} z={z}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

MIDBLOCK_PARK = """
{
    default_state: {order_index: 1, inserts: {turn: 0}},
    order: [
        {cmd:'label', name:'@loop'},
        {cmd:'math', input:'{turn} + 1', output_name:'turn'},
        {cmd:'parallel_%(mode)s', tasks:[
            {cmd:'serial', tasks:[
                {cmd:'set', item:'gen-{turn}', output_name:'gen'},
                {cmd:'print', text:'[{gen}]'},
            ]},
            {cmd:'serial', tasks:[
                {cmd:'user_input', prompt:'t{turn}? ',
                 output_name:'ans'},
                {cmd:'print', text:'<{ans}>'},
            ]},
        ]},
        {cmd:'goto_map', text:'{turn}', target_maps:[
            {'3': '@end'}, {'*': '@loop'}]},
        {cmd:'label', name:'@end'},
        {cmd:'print', text:'fin {gen} {ans}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

PARKED_FREEZE_PAR = """
{
    default_state: {order_index: 1, inserts: {}},
    order: [
        {cmd:'parallel_race', tasks:[
            {cmd:'serial', tasks:[
                {cmd:'set', item:'v', output_name:'side'},
            ]},
            {cmd:'serial', tasks:[
                {cmd:'user_input', prompt:'x? ', output_name:'x'},
                {cmd:'print', text:'{x}'},
            ]},
        ]},
        {cmd:'print', text:'after'},
    ],
    named_tasks: {}, save_states: {},
}
"""

SPILL_PARALLEL = """
{
    default_state: {order_index: 1, inserts: {i: 0}},
    order: [
        {cmd:'label', name:'@loop'},
        {cmd:'math', input:'{i} + 1', output_name:'i'},
        {cmd:'print', text:'line {i} of text;'},
        {cmd:'goto_map', text:'{i}', target_maps:[
            {'9': '@par'}, {'*': '@loop'}]},
        {cmd:'label', name:'@par'},
        {cmd:'parallel_wait', tasks:[
            {cmd:'serial', tasks:[
                {cmd:'user_input', prompt:'? ', output_name:'a'},
                {cmd:'print', text:'A={a};'},
            ]},
            {cmd:'serial', tasks:[
                {cmd:'print', text:'B;'},
            ]},
        ]},
        {cmd:'print', text:'end'},
    ],
    named_tasks: {}, save_states: {},
}
"""

# programs that run to DONE with the same output on host, JAX and port
AGREEING = {
    "copy_types": COPY_TYPES,
    "delete_clear": DELETE_CLEAR,
    "digit_math": DIGIT_MATH,
    "null_route": NULL_ROUTE,
    "newline_exact": NEWLINE_ROUTE % {"key": "hello"},
    "newline_suffix": NEWLINE_ROUTE % {"key": "*llo"},
    "newline_affix": NEWLINE_ROUTE % {"key": "he*llo"},
    "for_loop": FOR_LOOP,
    "for_mixed": FOR_MIXED,
    "for_nested": FOR_NESTED,
    "floor_div_mod": FLOOR_DIV_MOD,
    "int32_min_print": INT32_MIN_PRINT,
    "parse_digits": PARSE_DIGITS,
    "brace_in_hole": BRACE_IN_HOLE,
    "output_overflow": OUTPUT_OVERFLOW,
    "int_dispatch": INT_DISPATCH,
    "await_ready": AWAIT_READY,
}

# list and lane programs that run to DONE with the same output on host,
# JAX and port, with no host IO
LIST_AGREEING = {
    "list_spine": LIST_SPINE,
    "list_edges": LIST_EDGES,
    "for_dynamic": FOR_DYNAMIC,
    "par_wait": PAR_RACE % {"mode": "wait"},
    "par_race": PAR_RACE % {"mode": "race"},
}


def random_scalar_program(rng) -> dict:
    """A random program that plans to scalar instructions (and parks on
    user_input), for differentials; ``rng`` is a ``random.Random``. The
    values stay far from int32 overflow, where the TPU kernel and the host
    differ (ROADMAP Queue 3)."""
    keys = ["k1", "k2", "k3"]
    inserts = {"k1": rng.choice(["hello", 7, "a b", "-12", "1234567890"]),
               "k2": rng.randint(-99, 99), "k3": rng.choice(["", "5", "z"]),
               "w": "go", "n": "a\\{b\\}"}
    tasks = []
    n_labels = 0
    for _ in range(rng.randint(2, 9)):
        kind = rng.choice(["print", "set", "math", "math", "delete",
                           "label_goto", "goto_map", "for", "user_input"])
        if kind == "user_input":
            tasks.append({"cmd": "user_input", "prompt": "q? ",
                          "output_name": rng.choice(keys + ["ui"])})
        elif kind == "for":
            n = rng.randint(1, 4)
            var = rng.choice(["it", "jt"])
            lists = {var: [rng.choice(["a", "b", str(rng.randint(-9, 9)),
                                       rng.randint(-9, 9)])
                           for _ in range(n)]}
            body = [{"cmd": "set", "item": "<{" + var + "}>",
                     "output_name": rng.choice(keys)}]
            if rng.random() < 0.5:
                body.append({"cmd": "print", "text": "[{k3}]"})
            tasks.append({"cmd": "for", "name_list_map": lists,
                          "tasks": body})
        elif kind == "print":
            parts = [rng.choice(["t ", "x=", "{k1}", "{k2}", "{w}", "{k3}",
                                 "{n}", ";"])
                     for _ in range(rng.randint(1, 4))]
            tasks.append({"cmd": "print", "text": "".join(parts)})
        elif kind == "set":
            value = rng.choice(["plain", str(rng.randint(-50, 50)), "{k2}",
                                "{k1}", "v-{k2}-{w}", "{k1}{k1}", "",
                                "-007"])
            tasks.append({"cmd": "set", "item": value,
                          "output_name": rng.choice(keys)})
        elif kind == "math":
            expr = rng.choice([
                "1 + 2 * 3", "{k2} * 4 - 1", "max(1,{k2},3) - min(2,9)",
                "(7 % 3) + {k2}", "sign({k2})", "{k2} % 5", "-{k2} + 100",
                "{k2} % -7", "{k1} + 1", "{k3} * 2", "({k2} - 1) / 2",
                "{k2} * {k2} * {k2}"])
            tasks.append({"cmd": "math", "input": expr,
                          "output_name": rng.choice(keys)})
        elif kind == "delete":
            tasks.append({"cmd": "delete",
                          "wildcards": [rng.choice(["k1", "k2", "k*"])]})
        elif kind == "label_goto":
            name = f"@L{n_labels}"
            n_labels += 1
            tasks += [{"cmd": "goto", "name": name},
                      {"cmd": "print", "text": "SKIPPED"},
                      {"cmd": "label", "name": name}]
        else:
            name = f"@M{n_labels}"
            n_labels += 1
            tasks += [{"cmd": "goto_map", "text": rng.choice(
                          ["{w}", "{w}-{k2}", "fixed", "{k2}", "{k1}"]),
                       "target_maps": rng.sample([
                           {"go": name}, {"go-*": name}, {"*x": name},
                           {"NULL": name}, {"1": name}, {"-5": name},
                           {"hel*o": name}, {"*": name}], 4)},
                      {"cmd": "print", "text": "FELL"},
                      {"cmd": "label", "name": name}]
    return {"default_state": {"order_index": 1, "inserts": inserts},
            "order": tasks, "named_tasks": {}, "save_states": {}}


def random_program(rng) -> dict:
    """A random program over the whole turbo instruction mix: scalar ops,
    list ops (with a dynamic for), parallel_wait/race blocks whose lanes may
    block on user_input, and top-level user_input and user_choice parks;
    ``rng`` is a ``random.Random``. After the JAX package's generator
    (tests/test_turbo.py:365). Lane items cannot raise: a raced raising lane
    meets the reference's nondeterministic ``done.pop()``."""
    keys = ["k1", "k2", "k3"]
    inserts = {"k1": rng.choice(["hello", 7, "a b"]),
               "k2": rng.randint(-9, 99), "w": "go",
               "lst": [rng.choice(["e1", "x", str(rng.randint(0, 9))])
                       for _ in range(rng.randint(0, 4))]}
    tasks = []
    n_labels = 0
    for _ in range(rng.randint(2, 8)):
        kind = rng.choice(["print", "set", "math", "delete", "label_goto",
                           "goto_map", "for", "list_op", "list_op",
                           "parallel", "user_input", "user_choice"])
        if kind == "user_input":
            tasks.append({"cmd": "user_input", "prompt": "q? ",
                          "output_name": rng.choice(keys + ["ui"])})
        elif kind == "user_choice":
            tasks.append({"cmd": "user_choice", "description": "pick: ",
                          "list": ["alpha", "beta", "gm"],
                          "output_name": rng.choice(keys + ["uc"])})
        elif kind == "list_op":
            op = rng.choice(["append", "index", "slice", "join", "remove",
                             "length", "dynfor", "concat", "new"])
            if op == "append":
                tasks.append({"cmd": "list_append", "list": "{lst}",
                              "item": rng.choice(["z", "{w}", "i{k2}"]),
                              "output_name": "lst"})
            elif op == "index":
                # bounded by the length: a short list raises on the host
                tasks += [
                    {"cmd": "math", "input": "length(lst)",
                     "output_name": "n"},
                    {"cmd": "goto_map", "text": "{n}",
                     "target_maps": [{"0": f"@S{n_labels}"},
                                     {"1": f"@S{n_labels}"},
                                     {"*": "CONTINUE"}]},
                    {"cmd": "list_index", "list": "{lst}",
                     "index": rng.choice([1, -1, 2, "2"]),
                     "output_name": rng.choice(keys)},
                    {"cmd": "label", "name": f"@S{n_labels}"}]
                n_labels += 1
            elif op == "slice":
                tasks.append({"cmd": "list_slice", "list": "{lst}",
                              "from_index": rng.choice([1, 2, -2]),
                              "to_index": rng.choice([0, 2, -1, 9,
                                                      "length(lst)"]),
                              "output_name": rng.choice(["lst", "l2"])})
            elif op == "join":
                tasks.append({"cmd": "list_join", "list": "{lst}",
                              "before": rng.choice(["", "<"]),
                              "between": rng.choice(["", ",", "-"]),
                              "after": rng.choice(["", ">"]),
                              "output_name": rng.choice(keys)})
            elif op == "remove":
                tasks.append({"cmd": "list_remove", "list": "{lst}",
                              "item": rng.choice(["e1", "x", "absent"]),
                              "output_name": "lst"})
            elif op == "length":
                tasks.append({"cmd": "math", "input": "length(lst) * 2",
                              "output_name": rng.choice(keys)})
            elif op == "concat":
                tasks.append({"cmd": "list_concat",
                              "lists": rng.choice([["{lst}", "{lst}"],
                                                   ["{lst}"]]),
                              "output_name": rng.choice(["lst", "l3"])})
            elif op == "new":
                tasks.append({"cmd": "set", "item": rng.sample(
                    ["n1", "{w}", "m-{k2}", "x"], rng.randint(0, 3)),
                    "output_name": "lst"})
            else:
                tasks.append({"cmd": "for", "name_list_map": {"dv": "{lst}"},
                              "tasks": [{"cmd": "print",
                                         "text": "[{dv}]"}]})
        elif kind == "parallel":
            lanes = []
            for li in range(rng.randint(2, 3)):
                if rng.random() < 0.4:
                    body = [{"cmd": "user_input", "prompt": f"p{li}? ",
                             "output_name": rng.choice(keys + ["pv"])}]
                    if rng.random() < 0.5:
                        body.append({"cmd": "print", "text": f"u{li};"})
                else:
                    body = [{"cmd": "set",
                             "item": rng.choice(["p", "{w}", "q-{w}"]),
                             "output_name": rng.choice(keys + ["pv"])}]
                    if rng.random() < 0.5:
                        body.append({"cmd": "print", "text": f"l{li};"})
                lanes.append({"cmd": "serial", "tasks": body}
                             if rng.random() < 0.7 else body[0])
            tasks.append({"cmd": rng.choice(["parallel_wait",
                                             "parallel_race"]),
                          "tasks": lanes})
        elif kind == "for":
            n = rng.randint(1, 4)
            var = rng.choice(["it", "jt"])
            lists = {var: [rng.choice(["a", "b", str(rng.randint(0, 9))])
                           for _ in range(n)]}
            body = [{"cmd": "print", "text": "<{" + var + "}>"}]
            if rng.random() < 0.5:
                body.append({"cmd": "set", "item": "{" + var + "}!",
                             "output_name": rng.choice(keys)})
            tasks.append({"cmd": "for", "name_list_map": lists,
                          "tasks": body})
        elif kind == "print":
            tasks.append({"cmd": "print", "text": "".join(
                rng.choice(["t ", "x=", "{k1}", "{k2}", "{w}", "{lst}"])
                for _ in range(rng.randint(0, 3)))})
        elif kind == "set":
            tasks.append({"cmd": "set", "item": rng.choice(
                ["plain", str(rng.randint(-5, 50)), "{k2}", "v-{k2}-{w}"]),
                "output_name": rng.choice(keys)})
        elif kind == "math":
            tasks.append({"cmd": "math", "input": rng.choice([
                "1 + 2 * 3", "{k2} * 4 - 1", "max(1,{k2},3) - min(2,9)",
                "(7 % 3) + {k2}", "sign({k2})", "{k2} % 5", "-{k2} + 100"]),
                "output_name": rng.choice(keys)})
        elif kind == "delete":
            tasks.append({"cmd": "delete",
                          "wildcards": [rng.choice(["k1", "k2", "k*"])]})
        elif kind == "label_goto":
            name = f"@L{n_labels}"
            n_labels += 1
            tasks += [{"cmd": "goto", "name": name},
                      {"cmd": "print", "text": "SKIPPED"},
                      {"cmd": "label", "name": name}]
        else:
            name = f"@M{n_labels}"
            n_labels += 1
            tasks += [{"cmd": "goto_map", "text": rng.choice(
                          ["{w}", "{w}-{k2}", "fixed"]),
                       "target_maps": [
                           {"go": name}, {"go-*": name}, {"*x": name},
                           {"NULL": name}, {"*": name}]},
                      {"cmd": "print", "text": "FELL"},
                      {"cmd": "label", "name": name}]
    return {"default_state": {"order_index": 1, "inserts": inserts},
            "order": tasks, "named_tasks": {}, "save_states": {}}

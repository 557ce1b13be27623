"""The text-adventure rollout program, frozen.

Copied from ``interpolation_engine_tpu_torch/bench.py:199-256``
(``adventure_program``), character for character, under the name
``source``; ``portbench/tests`` hold the two equal. The traffic mix
resumes each instance from a saved state of its own (``traffic/``), so
the program's own default inserts serve no run.
"""


def source(n_rooms: int = 6, t_max: int = 1 << 30,
           trim: int = 10) -> str:
    """A text_adventure-shaped pure-compute spine: per room — history list
    append + length + trim-slice (the summarization window of
    text_adventure.json5:290-324), a parallel_race of a "generation" lane
    vs a "choice" lane (:66-198), goto_map dispatch to the next room.
    n_rooms=6 → ~120 instructions. Terminates at turn t_max."""
    rooms = []
    for r in range(n_rooms):
        nr = (r + 1) % n_rooms
        nr2 = (r + 3) % n_rooms
        rooms.append("""
        {cmd:'label', name:'@room-%(r)d'},
        {cmd:'clear'},
        {cmd:'math', input:'{turn} + 1', output_name:'turn'},
        {cmd:'set', item:'scene-%(r)d-{turn}', output_name:'scene'},
        {cmd:'list_append', list:'{hist}', item:'h%(r)d.{turn}',
         output_name:'hist'},
        {cmd:'math', input:'length(hist)', output_name:'hlen'},
        {cmd:'goto_map', text:'{hlen}', target_maps:[
            {'%(trim)d': '@trim-%(r)d'}, {'*': '@play-%(r)d'}]},
        {cmd:'label', name:'@trim-%(r)d'},
        {cmd:'list_slice', list:'{hist}', from_index:5,
         to_index:'{hlen}', output_name:'hist'},
        {cmd:'label', name:'@play-%(r)d'},
        {cmd:'parallel_race', tasks:[
            {cmd:'serial', tasks:[
                {cmd:'set', item:'gen-{scene}', output_name:'gen'},
                {cmd:'print', text:'{gen};'},
            ]},
            {cmd:'serial', tasks:[
                {cmd:'set', item:'c%(r)d', output_name:'choice'},
            ]},
        ]},
        {cmd:'math', input:'{acc} + {turn} %% 7', output_name:'acc'},
        {cmd:'goto_map', text:'{turn}', target_maps:[
            {'%(tmax)d': '@fin'}, {'*': '@hop-%(r)d'}]},
        {cmd:'label', name:'@hop-%(r)d'},
        {cmd:'goto_map', text:'{choice}-{hlen}', target_maps:[
            {'c%(r)d-3': '@room-%(nr2)d'},
            {'c*': '@room-%(nr)d'},
            {'*': '@fin'}]},
        """ % {"r": r, "nr": nr, "nr2": nr2, "tmax": t_max,
               "trim": trim})
    return """
    {
        default_state: {order_index: 1, inserts:
            {turn: 0, acc: 0, hist: ['seed'], choice: 'c0'}},
        order: [
            %s
            {cmd:'label', name:'@fin'},
            {cmd:'print', text:'fin turn={turn} '},
            {cmd:'print', text:'acc={acc} '},
            {cmd:'print', text:'hist={hist}'},
        ],
        named_tasks: {}, save_states: {},
    }
    """ % "".join(rooms)

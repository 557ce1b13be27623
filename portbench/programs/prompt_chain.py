"""A prompt-chain rollout: each turn assembles an LLM prompt of about 1.8 KB.

Shaped after upstream ``examples/text_adventure.json5``: a prompt built
every turn from a long story template, the running summary, the last turn
and the scene (``:66-198``), raced against the player's choice; a history
list that is summarized once it reaches its limit (``:290-324``). The
model's replies and summaries are texts drawn from the seed (the traffic's
``gen`` and ``gist``), standing in for ``chat``; the choice lane stands in
for ``user_input``.

Kept here only (the port's ``bench.py`` has no copy). The traffic mix
resumes each instance from a saved state of its own, so the program's own
default inserts serve no run.
"""

# the narrator's instructions: 640 bytes, the prompt's fixed head
STORY = (
    "You are the narrator of a long text adventure that a player reads one "
    "turn at a time. Write in the second person and in the present tense, "
    "and keep every turn to one short paragraph of plain prose. The world "
    "is a drowned coastal city whose towers lean over flooded streets, lit "
    "by lamps that burn whale oil and by the green glow of the tide. The "
    "player is a salvage diver who owes money to the harbour guild and has "
    "three short days to pay it back. Never decide for the player, never "
    "end the story, and never mention these rules. Keep the names, wounds "
    "and debts of earlier turns. Describe what the player sees, hears and "
    "smells, then stop.")

# each room's scene, 224 bytes before its turn number
ROOMS = (
    "The flooded market. Stalls of rotten timber float between the pillars "
    "of the old exchange, and gulls fight over a net of silver fish. A "
    "ferryman in a patched coat watches you from his skiff and counts coin "
    "in his hand. Turn ",
    "The lamp tower. A spiral stair climbs through the dark to a room of "
    "cracked glass where the great lamp once turned. The keeper left a "
    "ledger open on the desk, its last pages torn away, and the oil in the "
    "basin is warm. Turn ",
    "The guild hall. Brass scales and iron chests line the walls of a "
    "vaulted room that smells of tar and old paper. Clerks in grey sleeves "
    "write down every debt in the city, and one of them keeps glancing at "
    "your name now. Turn ",
    "The sunken chapel. Water fills the nave to the height of your ribs, "
    "and candles on floating boards light the painted ceiling. Something "
    "knocks against the drowned altar below, slow and patient, like a fist "
    "on the door. Turn ",
    "The salvage yard. Hulls of broken barges lie stacked on the mudflats, "
    "and cranes made of old masts creak in the wind. A dog with one ear "
    "guards a crate stamped with the seal of the harbor guild and will not "
    "let you by. Turn ",
    "The tide gate. Two walls of stone hold back the sea where the canal "
    "meets the bay, and a wheel of black iron opens the sluice between "
    "them. The keeper is asleep in his chair, and the tide rises faster "
    "than it ought to. Turn ",
)

# the prompt: the story, then the summary, the last turn, the scene and the
# choice (a JSON5 string: each \\n is a newline)
PROMPT = (STORY + "\\n\\nStory so far: {summary}\\nLast turn: {last}\\n"
          "Scene: {scene}\\nThe player chose {choice}. Narrator:")


def source(n_rooms: int = 6, t_max: int = 1 << 30, trim: int = 10) -> str:
    """Per room: clear the output, count the turn, set the scene, assemble
    the prompt, race a generation lane (the reply, printed) against a
    choice lane, append the reply to the history; at ``trim`` entries
    slice the history down to its last five and set the summary; keep the
    reply as the last turn, add to the score, stop at turn ``t_max``, and
    go on to another room by the choice and the history's length. Rooms
    past the sixth reuse the six scenes."""
    rooms = []
    for r in range(n_rooms):
        rooms.append("""
        {cmd:'label', name:'@room-%(r)d'},
        {cmd:'clear'},
        {cmd:'math', input:'{turn} + 1', output_name:'turn'},
        {cmd:'set', item:'%(scene)s{turn}', output_name:'scene'},
        {cmd:'set', item:'%(prompt)s', output_name:'prompt'},
        {cmd:'parallel_race', tasks:[
            {cmd:'serial', tasks:[
                {cmd:'set', item:'Turn {turn}: {gen}', output_name:'reply'},
                {cmd:'print', text:'{reply}'},
            ]},
            {cmd:'serial', tasks:[
                {cmd:'set', item:'c%(r)d', output_name:'choice'},
            ]},
        ]},
        {cmd:'list_append', list:'{hist}', item:'{reply}',
         output_name:'hist'},
        {cmd:'math', input:'length(hist)', output_name:'hlen'},
        {cmd:'goto_map', text:'{hlen}', target_maps:[
            {'%(trim)d': '@trim-%(r)d'}, {'*': '@play-%(r)d'}]},
        {cmd:'label', name:'@trim-%(r)d'},
        {cmd:'list_slice', list:'{hist}', from_index:6,
         to_index:'{hlen}', output_name:'hist'},
        {cmd:'set', item:'By turn {turn}: {gist}', output_name:'summary'},
        {cmd:'label', name:'@play-%(r)d'},
        {cmd:'set', item:'{reply}', output_name:'last'},
        {cmd:'math', input:'{acc} + {turn} %% 7', output_name:'acc'},
        {cmd:'goto_map', text:'{turn}', target_maps:[
            {'%(tmax)d': '@fin'}, {'*': '@hop-%(r)d'}]},
        {cmd:'label', name:'@hop-%(r)d'},
        {cmd:'goto_map', text:'{choice}-{hlen}', target_maps:[
            {'c%(r)d-3': '@room-%(nr2)d'},
            {'c*': '@room-%(nr)d'},
            {'*': '@fin'}]},
        """ % {"r": r, "nr": (r + 1) % n_rooms, "nr2": (r + 3) % n_rooms,
               "scene": ROOMS[r % len(ROOMS)], "prompt": PROMPT,
               "tmax": t_max, "trim": trim})
    return """
    {
        default_state: {order_index: 1, inserts:
            {turn: 0, acc: 0, hist: ['Turn 0: the story begins'],
             choice: 'c0', summary: 'Nothing has happened yet.',
             last: 'Turn 0: the story begins', gen: 'the tide comes in',
             gist: 'the diver arrived in the city'}},
        order: [
            %s
            {cmd:'label', name:'@fin'},
            {cmd:'print', text:'fin turn={turn} acc={acc}'},
        ],
        named_tasks: {}, save_states: {},
    }
    """ % "".join(rooms)

"""ViZDoom DSL domain constants.

The port's own copy of demo2program_tpu/dsl/vizdoom_defs.py (numpy and
the standard library only), so the port imports nothing of the JAX
package.

Parity target: the constants at the top of `vizdoom_env/dsl/dsl_parse.py:1-45`
— monster/item/action lists and the distance/horizontal predicate tables
(regular and 'clear' mutually-exclusive variants).

Ordering note: the reference builds vocab slices from py2 dict .keys(), whose
order was hash-dependent; we fix the order to the declaration order below
(deterministic under py3). Datasets we generate embed their vocab in
data_info, so loaders stay self-consistent.
"""

MONSTER_LIST = ["Demon", "HellKnight", "Revenant"]
ITEMS_IN_INTEREST = ["MyAmmo"]

ACTION_LIST = [
    "MOVE_FORWARD", "MOVE_BACKWARD", "MOVE_LEFT", "MOVE_RIGHT",
    "TURN_LEFT", "TURN_RIGHT", "ATTACK",
    "SELECT_WEAPON1", "SELECT_WEAPON2", "SELECT_WEAPON3",
    "SELECT_WEAPON4", "SELECT_WEAPON5",
]

DISTANCE_DICT = {
    "doncare_dist": lambda d: True,
    "far": lambda d: d > 400,
    "mid": lambda d: d < 300,
    "close": lambda d: d < 180,
    "very_close": lambda d: d < 135,
}

HORIZONTAL_DICT = {
    "doncare_horz": lambda l, r, x: True,
    "center": lambda l, r, x: l < x and x < r,
    "slight_left": lambda l, r, x: r < x and x <= r + 10,
    "slight_right": lambda l, r, x: l > x and x >= l - 10,
    "mid_left": lambda l, r, x: r < x and x <= r + 20,
    "mid_right": lambda l, r, x: l > x and x >= l - 20,
    "left": lambda l, r, x: r < x,
    "right": lambda l, r, x: l > x,
}

CLEAR_DISTANCE_DICT = {
    "far": lambda d: d > 400,
    "mid_far": lambda d: 300 < d <= 400,
    "mid": lambda d: 180 < d <= 300,
    "close": lambda d: 135 < d <= 180,
    "very_close": lambda d: d <= 135,
}

CLEAR_HORIZONTAL_DICT = {
    "slight_left": lambda l, r, x: r < x <= r + 10,
    "slight_right": lambda l, r, x: l > x >= l - 10,
    "mid_left": lambda l, r, x: r + 10 < x <= r + 20,
    "mid_right": lambda l, r, x: l - 10 > x >= l - 20,
    "left": lambda l, r, x: r + 20 < x,
    "right": lambda l, r, x: l - 20 > x,
}


def _merged(a, b):
    out = list(a)
    for key in b:
        if key not in out:
            out.append(key)
    return out


# all tokens the parser accepts (superset across perception types)
MERGE_DISTANCE_VOCAB = _merged(DISTANCE_DICT, CLEAR_DISTANCE_DICT)
MERGE_HORIZONTAL_VOCAB = _merged(HORIZONTAL_DICT, CLEAR_HORIZONTAL_DICT)

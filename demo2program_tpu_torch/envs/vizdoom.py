"""ViZDoom environment wrapper.

The port's own copy of demo2program_tpu/envs/vizdoom.py (numpy and
the standard library only), so the port imports nothing of the JAX
package.

Parity target: `vizdoom_env/vizdoom_env.py` — wraps the *deterministic*
ViZDoom C++ engine (`vizdoom_env/README.md:6-15`) with:

  * macro-action frame-skip schedules, incl. per-weapon ATTACK skips
    (`vizdoom_env.py:35-57,151-162`)
  * history recording of RGB frames / action strings / perception vectors
    per macro action, with post-action NONE frames and the capture-timing
    flag (`:115-135`)
  * perception primitives over the engine's label buffer
    (`:286-352`), delegated to pure functions so they are unit-testable
    without the engine
  * episode re-initialization by teleporting actors via `puke` console
    commands with the reference's fixed entity-id layout (`:354-380`)

The engine import is gated: everything except the Vizdoom_env class itself
works without the `vizdoom` package (the TPU training/eval path only needs
the engine for dataset generation and execution-accuracy scoring of doom
programs).
"""

import math
import os

import numpy as np

from demo2program_tpu_torch.dsl.vizdoom_defs import (
    CLEAR_DISTANCE_DICT, CLEAR_HORIZONTAL_DICT, DISTANCE_DICT,
    HORIZONTAL_DICT, ITEMS_IN_INTEREST, MONSTER_LIST)

PLAYER_NAME = ["DoomPlayer", "MyPlayer"]

# ACTION frames, POST-NONE frames, capture timing (0: before NONE, 1: after)
FRAME_SKIP = {
    "NONE": [1, 1, 1],
    "MOVE_FORWARD": [5, 30, 1],
    "MOVE_BACKWARD": [5, 30, 1],
    "MOVE_LEFT": [5, 30, 1],
    "MOVE_RIGHT": [5, 30, 1],
    "TURN_LEFT": [5, 5, 1],
    "TURN_RIGHT": [5, 5, 1],
    "ATTACK": [1, 40, 0],
    "SELECT_WEAPON1": [40, 1, 1],
    "SELECT_WEAPON2": [40, 1, 1],
    "SELECT_WEAPON3": [40, 1, 1],
    "SELECT_WEAPON4": [40, 1, 1],
    "SELECT_WEAPON5": [40, 1, 1],
}

ATTACK_FRAME_SKIP = {1: 10, 2: 5, 3: 2, 4: 2, 5: 9}

# puke entity-id layout for episode re-init (`vizdoom_env.py:354-380`)
PUKE_ID = {"player_pos": 20, "demon_pos": 21, "revenant_pos": 5,
           "hellknight_pos": 15, "ammo_pos": 10}


# ---- pure perception math (engine-independent, unit-testable) --------------

def in_target(actors, x_size, y_size):
    """Is any actor's screen bbox under the crosshair (`:293-305`)?"""
    cx, cy = x_size / 2, y_size / 2
    for a in actors:
        if (a.x < cx < a.x + a.width) and (a.y < cy < a.y + a.height):
            return True
    return False


def exist_actor_in_distance_horizontal(actors, player, x_size,
                                       dist_name, horz_name,
                                       distance_dict, horizontal_dict):
    """(`vizdoom_env.py:307-320`)."""
    cx = x_size / 2
    for a in actors:
        d = math.sqrt(
            (a.object_position_x - player.object_position_x) ** 2
            + (a.object_position_y - player.object_position_y) ** 2)
        if distance_dict[dist_name](d) and \
                horizontal_dict[horz_name](a.x, a.x + a.width, cx):
            return True
    return False


def perception_vector_cond(perception_type, distance_dict=None,
                           horizontal_dict=None):
    """Condition strings in perception-vector order (`:209-233`)."""
    vec = []
    if perception_type in ("simple", "more_simple"):
        for actor in MONSTER_LIST:
            vec.append(f"ISTHERE {actor}")
        if perception_type == "more_simple":
            return vec
        for actor in MONSTER_LIST:
            vec.append(f"INTARGET {actor}")
        return vec
    for dist in distance_dict:
        for horz in horizontal_dict:
            for actor in MONSTER_LIST + ITEMS_IN_INTEREST:
                vec.append(f"EXIST {actor} IN {dist} {horz}")
    for actor in MONSTER_LIST:
        vec.append(f"INTARGET {actor}")
    return vec


class VizdoomEngineUnavailable(ImportError):
    pass


DEFAULT_CONFIG = None  # resolved to the packaged doomlite.cfg below


class Vizdoom_env:
    """Engine-backed world.

    engine='auto' uses the `vizdoom` python package (the deterministic
    ViZDoom fork) when importable and otherwise falls back to the built-in
    deterministic software engine (envs/doomlite.py), which implements the
    same API surface, puke-init protocol and label-buffer semantics.
    engine='vizdoom' requires the package; engine='doomlite' forces the
    software engine."""

    def __init__(self, config=DEFAULT_CONFIG, verbose=False,
                 perception_type="more_simple", engine="auto",
                 sprite_style="v2"):
        DoomGame = ScreenResolution = None
        if engine in ("auto", "vizdoom"):
            try:
                from vizdoom import DoomGame, ScreenResolution
            except ImportError as e:
                if engine == "vizdoom":
                    raise VizdoomEngineUnavailable(
                        "the 'vizdoom' package (ViZDoomDeterministic fork) "
                        "is not installed; use engine='doomlite' or 'auto' "
                        "for the built-in software engine.") from e
        if DoomGame is None:
            from demo2program_tpu_torch.envs import doomlite
            DoomGame = doomlite.DoomGame
        if config is None:
            config = os.path.join(os.path.dirname(__file__), "..",
                                  "assets", "doomlite.cfg")
        self.verbose = verbose
        self.game = DoomGame()
        self.sprite_style = sprite_style
        if sprite_style != "v2":
            # sprite styles only exist in the DoomLite software renderer;
            # the real engine's art is fixed by its wad
            if not hasattr(self.game, "set_sprite_style"):
                raise ValueError(
                    f"sprite_style {sprite_style!r} requires the DoomLite "
                    "engine (the vizdoom engine's art is wad-defined)")
            self.game.set_sprite_style(sprite_style)
        self.game.load_config(config)
        if verbose and ScreenResolution is not None:
            self.game.set_window_visible(True)
            self.game.set_screen_resolution(ScreenResolution.RES_1280X960)
        self.game_variables = self.game.get_available_game_variables()
        self.buttons = self.game.get_available_buttons()
        self.action_strings = [str(b).replace("Button.", "")
                               for b in self.buttons]
        self.game_variable_strings = [str(v).replace("GameVariable.", "")
                                      for v in self.game_variables]
        self.perception_type = perception_type
        if perception_type == "clear":
            self.distance_dict = CLEAR_DISTANCE_DICT
            self.horizontal_dict = CLEAR_HORIZONTAL_DICT
        elif perception_type in ("simple", "more_simple"):
            self.distance_dict = None
            self.horizontal_dict = None
        else:
            self.distance_dict = DISTANCE_DICT
            self.horizontal_dict = HORIZONTAL_DICT

    # -- lifecycle ------------------------------------------------------------
    def init_game(self):
        self.game.init()
        self.new_episode()

    def end_game(self):
        self.game.close()

    def new_episode(self, init_state=None):
        self.game.new_episode()
        if init_state is not None:
            self.initialize_state(init_state)
        self.take_action("NONE")
        state = self.game.get_state()
        if state is None:
            raise RuntimeError("Cannot get initial states")
        img = np.transpose(state.screen_buffer.copy(), [1, 2, 0])
        self.y_size, self.x_size, self.channel = img.shape
        self.get_state()
        self.s_h = [img.copy()]
        self.a_h = []
        self.p_v_h = [self.get_perception_vector().copy()]

    def initialize_state(self, init_state):
        for key, base_id in PUKE_ID.items():
            if key not in init_state:
                continue
            val = init_state[key]
            if key == "player_pos":
                x, y = val
                self.game.send_game_command(f"puke {base_id} {x} {y}")
            else:
                for i, (x, y) in enumerate(val):
                    self.game.send_game_command(f"puke {base_id + i} {x} {y}")

    # -- stepping --------------------------------------------------------------
    def take_action(self, action):
        action_vector = [a == action for a in self.action_strings]
        frame_skip = FRAME_SKIP[action][0]
        if action == "ATTACK":
            state = self.game.get_state()
            gv = dict(zip(self.game_variable_strings, state.game_variables))
            frame_skip = ATTACK_FRAME_SKIP[int(gv["SELECTED_WEAPON"])]
        self.game.make_action(action_vector, frame_skip)

    def post_none(self, action):
        none_vector = [a == "NONE" for a in self.action_strings]
        self.game.make_action(none_vector, FRAME_SKIP[action][1])

    def state_transition(self, action_string):
        if action_string != "NONE" and \
                action_string not in self.action_strings:
            raise ValueError("Unknown action")
        self.take_action(action_string)
        self.a_h.append(action_string)
        if FRAME_SKIP[action_string][2] == 0:
            self._capture()
        self.post_none(action_string)
        if FRAME_SKIP[action_string][2] == 1:
            self._capture()

    def _capture(self):
        self.get_state()
        self.s_h.append(self.screen.copy())
        self.p_v_h.append(self.get_perception_vector().copy())

    # -- engine state ingestion -------------------------------------------------
    def get_state(self):
        state = self.game.get_state()
        if state is None:
            self.game_variable_values = {}
            self.player = None
            self.monsters = []
            self.actors = {}
            return
        self.game_variable_values = dict(
            zip(self.game_variable_strings, state.game_variables))
        self.monsters = []
        self.actors = {}
        for l in state.labels:
            if l.object_name in PLAYER_NAME:
                self.player = l
            else:
                if l.object_name in MONSTER_LIST:
                    self.monsters.append(l)
                self.actors.setdefault(l.object_name, []).append(l)
        self.labels = state.labels
        self.screen = np.transpose(state.screen_buffer, [1, 2, 0]).copy()

    def get_actor_by_name(self, name):
        return self.actors.setdefault(name, [])

    # -- perception primitives ---------------------------------------------------
    def is_there(self, actor):
        return len(self.get_actor_by_name(actor)) > 0

    def in_target(self, actor):
        return in_target(self.get_actor_by_name(actor),
                         self.x_size, self.y_size)

    def exist_actor_in_distance_horizontal(self, actor, dist, horz):
        return exist_actor_in_distance_horizontal(
            self.get_actor_by_name(actor), self.player, self.x_size,
            dist, horz, self.distance_dict, self.horizontal_dict)

    def have_weapon(self, slot):
        return self.game_variable_values[f"WEAPON{slot}"] > 0

    def have_ammo(self, slot):
        if slot == 1:  # fist / chainsaw
            return True
        return self.game_variable_values[f"AMMO{slot}"] > 0

    def selected_weapon(self, slot):
        return self.game_variable_values["SELECTED_WEAPON"] == slot

    def no_selected_weapon_ammo(self):
        return self.game_variable_values["SELECTED_WEAPON_AMMO"] == 0

    # -- perception vectors --------------------------------------------------------
    def get_perception_vector_cond(self):
        return perception_vector_cond(
            self.perception_type, self.distance_dict, self.horizontal_dict)

    def get_perception_vector(self):
        if self.perception_type in ("simple", "more_simple"):
            vec = [self.is_there(a) for a in MONSTER_LIST]
            if self.perception_type == "more_simple":
                return np.array(vec)
            vec += [self.in_target(a) for a in MONSTER_LIST]
            return np.array(vec)
        vec = []
        for dist in self.distance_dict:
            for horz in self.horizontal_dict:
                for actor in MONSTER_LIST + ITEMS_IN_INTEREST:
                    vec.append(self.exist_actor_in_distance_horizontal(
                        actor, dist, horz))
        for actor in MONSTER_LIST:
            vec.append(self.in_target(actor))
        return np.array(vec)

    def get_action_list(self):
        return self.action_strings

"""DoomLite: a deterministic software Doom engine (vizdoom-API subset).

The port's own copy of demo2program_tpu/envs/doomlite.py (numpy and
the standard library only), so the port imports nothing of the JAX
package.

The reference depends on an external C++ engine — the ViZDoomDeterministic
fork of ZDoom (`vizdoom_env/README.md:6-15`) with a custom `doom_state.wad`
scenario — for ViZDoom dataset generation and for replaying predicted
programs during execution-accuracy evaluation
(`models/model_full.py:848-873`). That binary engine and wad cannot be
shipped or fetched here, so this module provides a from-scratch,
bit-deterministic software engine implementing exactly the API surface the
framework touches (`vizdoom_env/vizdoom_env.py`):

    DoomGame: load_config / init / close / new_episode / get_state /
              make_action(button_vector, tics) / send_game_command("puke …")
              get_available_buttons / get_available_game_variables
    GameState: screen_buffer (C,H,W uint8, planar RGB = CRCGCB),
               game_variables, labels (screen bboxes + world positions)

World model (documented deviations from real Doom in brackets):
  * one rectangular arena containing the reference generator's spawn box
    x in [-480, 64], y in [64, 480] (`vizdoom_env/generator.py:24-27`)
  * 5 slots each of Demon / HellKnight / Revenant and 5 MyAmmo items start
    INACTIVE (the wad's monster-closet equivalent); `puke <script> <x> <y>`
    console commands teleport-activate them with the reference's script-id
    layout: player 20, demon 21+i, revenant 5+i, hellknight 15+i, ammo 10+i
    (`vizdoom_env.py:354-380`)
  * per-tic player motion (8 u/tic moves, 5 deg/tic turns), hitscan attacks
    with fixed per-weapon damage [no damage rng — determinism is the point],
    monster HP by species; monsters activate on weapon noise and then chase
    the player [real Doom AI sees/hears with rng; here: idle until first
    shot, then deterministic chase], corpses leave the label buffer
  * renderer: 90-degree-FOV perspective projection — raycast walls,
    billboarded species-colored monster sprites with distance shading, floor
    and ceiling gradients, a selected-weapon sprite [flat-shaded shapes, not
    Doom art assets]. Labels are derived from the same projection, so
    `is_there` keeps the engine semantics "object visible on screen".

Everything is pure numpy with no randomness: identical action sequences from
identical init states reproduce frames bit-exactly, which is what the
execution-accuracy metric requires (`model_full.py:892-916`).
"""

import math
import os

import numpy as np

# ---- constants --------------------------------------------------------------

BUTTONS = [
    "MOVE_FORWARD", "MOVE_BACKWARD", "MOVE_LEFT", "MOVE_RIGHT",
    "TURN_LEFT", "TURN_RIGHT", "ATTACK",
    "SELECT_WEAPON1", "SELECT_WEAPON2", "SELECT_WEAPON3",
    "SELECT_WEAPON4", "SELECT_WEAPON5", "SELECT_WEAPON6",
    "SELECT_NEXT_WEAPON", "SELECT_PREV_WEAPON",
]

GAME_VARIABLES = [
    "ANGLE", "PITCH", "ROLL", "POSITION_X", "POSITION_Y", "POSITION_Z",
    "VELOCITY_X", "VELOCITY_Y", "VELOCITY_Z",
    "ON_GROUND", "ATTACK_READY", "ALTATTACK_READY",
    "SELECTED_WEAPON", "SELECTED_WEAPON_AMMO",
    "ITEMCOUNT", "KILLCOUNT", "HEALTH", "ARMOR",
    "AMMO0", "AMMO1", "AMMO2", "AMMO3", "AMMO4", "AMMO5", "AMMO6",
    "AMMO7", "AMMO8", "AMMO9",
    "WEAPON0", "WEAPON1", "WEAPON2", "WEAPON3", "WEAPON4", "WEAPON5",
    "WEAPON6", "WEAPON7", "WEAPON8", "WEAPON9",
]

# arena walls (contains the spawn box with margin)
ARENA = {"x_min": -576.0, "x_max": 160.0, "y_min": -32.0, "y_max": 576.0}
WALL_HEIGHT = 128.0
EYE_Z = 41.0          # Doom player eye height
PLAYER_RADIUS = 16.0
SPAWN = (-208.0, 272.0, 90.0)  # default spawn: box centre, facing north

MOVE_PER_TIC = 8.0    # forward/strafe units per tic
TURN_PER_TIC = 5.0    # degrees per tic
FOV_DEG = 90.0

# species: (height, radius, hp, speed u/tic, rgb colour). Colours are
# deliberately far apart in RGB: v1 used muted doom-ish hues and the trained
# ifelse models confused the species after 80x80 downsizing + distance fade
# (the dominant test error — RESULTS.md round 2); these survive both.
SPECIES = {
    "Demon": (56.0, 30.0, 150, 2.33, (235, 40, 60)),        # red
    "HellKnight": (64.0, 24.0, 500, 1.66, (40, 220, 60)),   # green
    "Revenant": (80.0, 20.0, 300, 2.33, (245, 245, 235)),   # bone white
}
AMMO_ITEM = {"height": 16.0, "radius": 10.0, "colour": (210, 180, 60)}
PICKUP_RADIUS = 48.0
AMMO_PER_PICKUP = 10
CHASE_STOP_DIST = 96.0

# weapon slot -> (damage per shot, refire cooldown tics, range, colour)
WEAPONS = {
    1: (11, 16, 64.0, (170, 150, 130)),    # fist (melee)
    2: (10, 14, 2048.0, (120, 120, 130)),  # pistol
    3: (70, 37, 2048.0, (90, 70, 50)),     # shotgun
    4: (15, 4, 2048.0, (140, 60, 50)),     # chaingun
    5: (128, 70, 2048.0, (70, 90, 60)),    # rocket launcher [instant hit]
}

# puke script-id layout (`vizdoom_env.py:354-380`)
PUKE_PLAYER = 20
PUKE_BASE = {"Demon": 21, "Revenant": 5, "HellKnight": 15, "MyAmmo": 10}
SLOTS_PER_KIND = 5

EPISODE_START_TICS = 14   # cfg episode_start_time
DEFAULT_TIMEOUT = 1000


class Label:
    """vizdoom.Label subset: screen bbox + world position."""

    __slots__ = ("object_name", "object_id", "x", "y", "width", "height",
                 "object_position_x", "object_position_y",
                 "object_position_z")

    def __init__(self, name, oid, x, y, w, h, wx, wy, wz=0.0):
        self.object_name = name
        self.object_id = oid
        self.x = x
        self.y = y
        self.width = w
        self.height = h
        self.object_position_x = wx
        self.object_position_y = wy
        self.object_position_z = wz


class GameState:
    __slots__ = ("screen_buffer", "game_variables", "labels", "number")

    def __init__(self, screen, game_variables, labels, number):
        self.screen_buffer = screen
        self.game_variables = game_variables
        self.labels = labels
        self.number = number


class _Actor:
    __slots__ = ("kind", "slot", "x", "y", "hp", "active", "alerted")

    def __init__(self, kind, slot):
        self.kind = kind
        self.slot = slot
        self.x = 0.0
        self.y = 0.0
        self.hp = 0
        self.active = False
        self.alerted = False


def _parse_cfg(path):
    """Minimal .cfg reader: key = value lines; {...} button/variable blocks
    are accepted but this engine's surface is fixed."""
    out = {}
    if not path or not os.path.exists(path):
        return out
    with open(path) as f:
        text = f.read()
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if "=" in line and "{" not in line:
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


class DoomGame:
    """Deterministic software engine behind the Vizdoom_env wrapper."""

    def __init__(self):
        self.width = 160
        self.height = 120
        self.timeout = DEFAULT_TIMEOUT
        self._inited = False
        self._episode = 0
        # sprite rendering style; "v2" (default) is frozen — stored datasets
        # are compared frame-bitwise against live replays, so any change
        # must be an opt-in new style ("v3" adds species-unique silhouette
        # carving on top of the v2 colours + two-tone bands)
        self.sprite_style = "v2"

    def set_sprite_style(self, style):
        if style not in ("v2", "v3"):
            raise ValueError(f"unknown sprite_style {style!r}")
        self.sprite_style = style
        self._screen_cache = None

    # -- configuration (vizdoom API names) ------------------------------------
    def load_config(self, path):
        cfg = _parse_cfg(path)
        res = cfg.get("screen_resolution", "RES_160X120").upper()
        if "X" in res.replace("RES_", ""):
            w, h = res.replace("RES_", "").split("X")
            self.width, self.height = int(w), int(h)
        self.timeout = int(cfg.get("episode_timeout", DEFAULT_TIMEOUT))
        return True

    def set_window_visible(self, v):
        pass

    def set_screen_resolution(self, res):
        pass

    def get_available_buttons(self):
        return list(BUTTONS)

    def get_available_game_variables(self):
        return list(GAME_VARIABLES)

    # -- lifecycle -------------------------------------------------------------
    def init(self):
        self._inited = True

    def close(self):
        self._inited = False

    def new_episode(self):
        self._episode += 1
        self.tic = 0
        self._screen_cache = None
        self.finished = False
        self.px, self.py, self.angle = SPAWN
        self.cooldown = 0
        self.selected = 2
        self.switch_tics = 0
        self.ammo = [0] * 10
        self.ammo[2] = 50
        self.weapons = [0] * 10
        self.weapons[1] = 1
        self.weapons[2] = 1
        self.killcount = 0
        self.itemcount = 0
        self.actors = []
        for kind in ("Demon", "HellKnight", "Revenant"):
            for s in range(SLOTS_PER_KIND):
                self.actors.append(_Actor(kind, s))
        self.items = [_Actor("MyAmmo", s) for s in range(SLOTS_PER_KIND)]
        # episode_start_time: the engine idles before control begins
        self._advance_tics(EPISODE_START_TICS, np.zeros(len(BUTTONS), bool))

    def is_episode_finished(self):
        return self.finished

    # -- console ---------------------------------------------------------------
    def send_game_command(self, cmd):
        parts = cmd.split()
        if not parts or parts[0] != "puke":
            return
        sid, x, y = int(parts[1]), float(parts[2]), float(parts[3])
        self._screen_cache = None
        if sid == PUKE_PLAYER:
            self.px, self.py = x, y
            return
        for kind, base in PUKE_BASE.items():
            if base <= sid < base + SLOTS_PER_KIND:
                slot = sid - base
                pool = self.items if kind == "MyAmmo" else self.actors
                for a in pool:
                    if a.kind == kind and a.slot == slot:
                        a.x, a.y = x, y
                        a.active = True
                        a.alerted = False
                        if kind != "MyAmmo":
                            a.hp = SPECIES[kind][2]
                return

    # -- stepping ----------------------------------------------------------------
    def make_action(self, action_vector, tics=1):
        vec = np.asarray(action_vector, dtype=bool)
        self._advance_tics(tics, vec)
        return 0.0

    def _advance_tics(self, tics, vec):
        pressed = [BUTTONS[i] for i in range(min(len(vec), len(BUTTONS)))
                   if vec[i]]
        action = pressed[0] if pressed else "NONE"
        while tics > 0:
            if self.finished:
                return
            # fast-forward fully-idle NONE tics (no chasing monsters, no
            # cooldown/switch timers): world state is provably unchanged, so
            # only the tic counter advances. NONE post-action frames are
            # 30-40 tics per macro — this is the datagen hot path.
            if (action == "NONE" and self.cooldown == 0
                    and self.switch_tics == 0
                    and not any(m.active and m.alerted
                                for m in self.actors)
                    # _tic also performs ammo pickup: an active item in
                    # range would be collected on the slow path, so it
                    # blocks the fast-forward (ADVICE r2)
                    and not any(it.active and math.hypot(
                        it.x - self.px, it.y - self.py) < PICKUP_RADIUS
                        for it in self.items)):
                skip = min(tics, self.timeout - self.tic)
                self.tic += skip
                tics -= skip
                if self.tic >= self.timeout:
                    self.finished = True
                continue
            self._tic(action)
            self._screen_cache = None
            self.tic += 1
            tics -= 1
            if self.tic >= self.timeout:
                self.finished = True

    def _tic(self, action):
        a = math.radians(self.angle)
        dx, dy = math.cos(a), math.sin(a)
        if action == "MOVE_FORWARD":
            self._move(dx * MOVE_PER_TIC, dy * MOVE_PER_TIC)
        elif action == "MOVE_BACKWARD":
            self._move(-dx * MOVE_PER_TIC, -dy * MOVE_PER_TIC)
        elif action == "MOVE_LEFT":
            self._move(-dy * MOVE_PER_TIC, dx * MOVE_PER_TIC)
        elif action == "MOVE_RIGHT":
            self._move(dy * MOVE_PER_TIC, -dx * MOVE_PER_TIC)
        elif action == "TURN_LEFT":
            self.angle = (self.angle + TURN_PER_TIC) % 360.0
        elif action == "TURN_RIGHT":
            self.angle = (self.angle - TURN_PER_TIC) % 360.0
        elif action.startswith("SELECT_WEAPON"):
            slot = int(action[-1])
            if 1 <= slot <= 5 and self.weapons[slot]:
                if self.selected != slot:
                    self.selected = slot
                    self.switch_tics = 8
        elif action == "ATTACK":
            self._try_fire()

        if self.cooldown > 0:
            self.cooldown -= 1
        if self.switch_tics > 0:
            self.switch_tics -= 1

        # item pickup
        for it in self.items:
            if it.active and math.hypot(it.x - self.px,
                                        it.y - self.py) < PICKUP_RADIUS:
                it.active = False
                self.itemcount += 1
                self.ammo[2] = min(self.ammo[2] + AMMO_PER_PICKUP, 200)

        # alerted monsters chase deterministically
        for m in self.actors:
            if not (m.active and m.alerted):
                continue
            mdx, mdy = self.px - m.x, self.py - m.y
            dist = math.hypot(mdx, mdy)
            speed = SPECIES[m.kind][3]
            if dist > CHASE_STOP_DIST:
                m.x += mdx / dist * speed
                m.y += mdy / dist * speed

    def _move(self, dx, dy):
        self.px = float(np.clip(self.px + dx,
                                ARENA["x_min"] + PLAYER_RADIUS,
                                ARENA["x_max"] - PLAYER_RADIUS))
        self.py = float(np.clip(self.py + dy,
                                ARENA["y_min"] + PLAYER_RADIUS,
                                ARENA["y_max"] - PLAYER_RADIUS))

    def _try_fire(self):
        if self.cooldown > 0 or self.switch_tics > 0:
            return
        dmg, refire, rng, _ = WEAPONS[self.selected]
        if self.selected != 1:
            if self.ammo[self.selected] <= 0:
                return
            self.ammo[self.selected] -= 1
        self.cooldown = refire
        # weapon noise alerts every active monster
        for m in self.actors:
            if m.active:
                m.alerted = True
        # hitscan: nearest alive monster whose sprite covers screen centre
        best, best_d = None, None
        for m in self.actors:
            if not m.active:
                continue
            proj = self._project(m.x, m.y, SPECIES[m.kind][1])
            if proj is None:
                continue
            sx0, sx1, d = proj
            if d > rng:
                continue
            if sx0 <= self.width / 2.0 <= sx1:
                if best is None or d < best_d:
                    best, best_d = m, d
        if best is not None:
            best.hp -= dmg
            if best.hp <= 0:
                best.active = False   # corpse leaves the label buffer
                self.killcount += 1

    # -- projection / rendering ---------------------------------------------------
    def _proj_plane(self):
        return (self.width / 2.0) / math.tan(math.radians(FOV_DEG / 2.0))

    def _project(self, wx, wy, radius):
        """World point -> (screen_x_left, screen_x_right, forward_dist)
        or None when behind the view plane."""
        a = math.radians(self.angle)
        rx, ry = wx - self.px, wy - self.py
        fwd = rx * math.cos(a) + ry * math.sin(a)
        side = -rx * math.sin(a) + ry * math.cos(a)
        if fwd < 1.0:
            return None
        proj = self._proj_plane()
        cx = self.width / 2.0 - side * proj / fwd
        half_w = radius * proj / fwd
        return cx - half_w, cx + half_w, fwd

    def _label_for(self, actor, name, height, radius):
        p = self._project(actor.x, actor.y, radius)
        if p is None:
            return None
        sx0, sx1, d = p
        if sx1 < 0 or sx0 >= self.width:
            return None
        proj = self._proj_plane()
        horizon = self.height / 2.0
        top = horizon - (height - EYE_Z) * proj / d
        bot = horizon + EYE_Z * proj / d
        x = max(0.0, sx0)
        y = max(0.0, top)
        w = min(float(self.width), sx1) - x
        h = min(float(self.height), bot) - y
        if w <= 0 or h <= 0:
            return None
        return Label(name, actor.slot, x, y, w, h, actor.x, actor.y)

    def _render(self):
        H, W = self.height, self.width
        img = np.zeros((H, W, 3), np.uint8)
        horizon = H // 2
        # ceiling / floor gradients (vectorized rows)
        rows = np.arange(H)[:, None, None]
        ceil = (40 + 30 * (horizon - rows[:horizon]) / max(horizon, 1)
                ).astype(np.uint8)
        img[:horizon] = ceil * np.array([1.0, 1.0, 1.1])[None, None, :]
        floor = (50 + 60 * (rows[horizon:] - horizon) / max(H - horizon, 1)
                 ).astype(np.uint8)
        img[horizon:] = floor * np.array([1.1, 0.9, 0.7])[None, None, :]

        # walls: one ray per column against the arena rectangle
        proj = self._proj_plane()
        a0 = math.radians(self.angle)
        cols = np.arange(W)
        # ray direction per column in world space
        cam_x = (cols + 0.5 - W / 2.0) / proj
        dir_x = math.cos(a0) - cam_x * math.sin(a0)
        dir_y = math.sin(a0) + cam_x * math.cos(a0)
        with np.errstate(divide="ignore", invalid="ignore"):
            tx1 = (ARENA["x_min"] - self.px) / dir_x
            tx2 = (ARENA["x_max"] - self.px) / dir_x
            ty1 = (ARENA["y_min"] - self.py) / dir_y
            ty2 = (ARENA["y_max"] - self.py) / dir_y
        t = np.full(W, 1e9)
        for tc in (tx1, tx2, ty1, ty2):
            tc = np.where(np.isfinite(tc) & (tc > 0), tc, 1e9)
            t = np.minimum(t, tc)
        fwd = t * (dir_x * math.cos(a0) + dir_y * math.sin(a0))
        fwd = np.maximum(fwd, 1.0)
        wall_top = horizon - (WALL_HEIGHT - EYE_Z) * proj / fwd
        wall_bot = horizon + EYE_Z * proj / fwd
        shade = np.clip(170 - fwd * 0.18, 35, 170).astype(np.uint8)
        rows_f = np.arange(H)[:, None]
        wall_mask = (rows_f >= wall_top[None, :]) & \
                    (rows_f < wall_bot[None, :])
        wall_rgb = np.stack([shade, shade,
                             (shade * 0.92).astype(np.uint8)], axis=-1)
        img[wall_mask] = np.broadcast_to(
            wall_rgb[None, :, :], (H, W, 3))[wall_mask]

        # sprites far-to-near
        drawables = []
        for it in self.items:
            if it.active:
                drawables.append((it, "MyAmmo", AMMO_ITEM["height"],
                                  AMMO_ITEM["radius"], AMMO_ITEM["colour"]))
        for m in self.actors:
            if m.active:
                h, r, _, _, colour = SPECIES[m.kind]
                drawables.append((m, m.kind, h, r, colour))
        projected = []
        for actor, name, h, r, colour in drawables:
            lab = self._label_for(actor, name, h, r)
            if lab is not None:
                p = self._project(actor.x, actor.y, r)
                projected.append((p[2], lab, name, colour))
        projected.sort(key=lambda e: -e[0])
        for d, lab, name, colour in projected:
            x0, x1 = int(lab.x), int(math.ceil(lab.x + lab.width))
            y0, y1 = int(lab.y), int(math.ceil(lab.y + lab.height))
            fade = max(0.6, min(1.0, 220.0 / (d + 40.0)))
            c = (np.array(colour, np.float32) * fade).astype(np.uint8)
            bg = (img[y0:y1, x0:x1].copy()
                  if self.sprite_style == "v3" else None)
            img[y0:y1, x0:x1] = c
            # Species-specific two-tone pattern so kinds read by SHAPE as
            # well as hue at small sizes: Demon = dark head band (top),
            # HellKnight = dark leg band (bottom), Revenant = dark side
            # stripes.  All patterns stay OFF the sprite centre so the
            # centre pixel remains the pure faded species colour (locked by
            # test_species_distinguishable_after_downsize).
            dark = (c * 0.6).astype(np.uint8)
            band = max(1, (y1 - y0) // 5)
            if name == "HellKnight":
                img[y1 - band:y1, x0:x1] = dark
            elif name == "Revenant":
                sw = max(1, (x1 - x0) // 4)
                img[y0:y1, x0:x0 + sw] = dark
                img[y0:y1, x1 - sw:x1] = dark
            else:  # Demon, MyAmmo
                img[y0:y0 + band, x0:x1] = dark
            # "v3": species-unique SILHOUETTES on top of colour + bands —
            # carve background back through the rect so the outline itself
            # identifies the kind (shape survives 80x80 downsizing better
            # than interior bands; all carves stay off the bbox centre
            # pixel so label-centre probes still read the species colour):
            #   Demon      = narrow head  (top corners carved)
            #   HellKnight = horned top   (top centre carved)
            #   Revenant   = split legs   (bottom centre carved)
            if bg is not None and name in SPECIES:
                bw, bh = x1 - x0, y1 - y0
                if bw >= 4 and bh >= 5:
                    if name == "Demon":
                        t = max(1, bh * 3 // 10)
                        s = max(1, bw // 4)
                        img[y0:y0 + t, x0:x0 + s] = bg[:t, :s]
                        img[y0:y0 + t, x1 - s:x1] = bg[:t, bw - s:]
                    elif name == "HellKnight":
                        t = max(1, bh // 4)
                        s = max(1, bw // 3)
                        m0 = (bw - s) // 2
                        img[y0:y0 + t, x0 + m0:x0 + m0 + s] = \
                            bg[:t, m0:m0 + s]
                    else:  # Revenant
                        t = max(1, bh * 2 // 5)
                        s = max(1, bw // 3)
                        m0 = (bw - s) // 2
                        img[y1 - t:y1, x0 + m0:x0 + m0 + s] = \
                            bg[bh - t:, m0:m0 + s]

        # selected-weapon sprite, bottom centre (render_weapon = true)
        wc = np.array(WEAPONS[self.selected][3], np.uint8)
        ww, wh = W // 6, H // 7
        x0 = W // 2 - ww // 2
        img[H - wh:, x0:x0 + ww] = wc
        img[H - wh:H - wh + 2, x0:x0 + ww] = (wc * 0.5).astype(np.uint8)
        return img

    # -- state ----------------------------------------------------------------------
    def get_state(self):
        if self.finished:
            return None
        # world state is unchanged between renders more often than not
        # (percept queries between actions, idle NONE frames) — cache the
        # framebuffer until a tic/puke mutates the world
        if self._screen_cache is None:
            self._screen_cache = self._render()
        img = self._screen_cache
        labels = [Label("DoomPlayer", 0, 0.0, 0.0, 0.0, 0.0,
                        self.px, self.py)]
        for m in self.actors:
            if m.active:
                h, r, _, _, _ = SPECIES[m.kind]
                lab = self._label_for(m, m.kind, h, r)
                if lab is not None:
                    labels.append(lab)
        for it in self.items:
            if it.active:
                lab = self._label_for(it, "MyAmmo", AMMO_ITEM["height"],
                                      AMMO_ITEM["radius"])
                if lab is not None:
                    labels.append(lab)
        gv = self._game_variables()
        screen = np.transpose(img, (2, 0, 1)).copy()  # CRCGCB planar
        return GameState(screen, gv, labels, self.tic)

    def _game_variables(self):
        vals = {
            "ANGLE": self.angle, "PITCH": 0.0, "ROLL": 0.0,
            "POSITION_X": self.px, "POSITION_Y": self.py,
            "POSITION_Z": EYE_Z,
            "VELOCITY_X": 0.0, "VELOCITY_Y": 0.0, "VELOCITY_Z": 0.0,
            "ON_GROUND": 1.0,
            "ATTACK_READY": float(self.cooldown == 0),
            "ALTATTACK_READY": 0.0,
            "SELECTED_WEAPON": float(self.selected),
            "SELECTED_WEAPON_AMMO": float(
                self.ammo[self.selected] if self.selected != 1 else 0),
            "ITEMCOUNT": float(self.itemcount),
            "KILLCOUNT": float(self.killcount),
            "HEALTH": 100.0, "ARMOR": 0.0,
        }
        for i in range(10):
            vals[f"AMMO{i}"] = float(self.ammo[i])
            vals[f"WEAPON{i}"] = float(self.weapons[i])
        return [vals[name] for name in GAME_VARIABLES]

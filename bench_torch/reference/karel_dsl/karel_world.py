"""Karel grid-world simulator (host-side numpy oracle).

The benchmark's copy of demo2program_tpu_torch/envs/karel.py, frozen
with the yardstick: the plain reference replays and executes demos with it.

Semantics parity target: the reference `karel_env/karel.py:33-185`.

State encoding — an (h, w, 16) bool grid:
  channels 0-3   agent present facing North/East/South/West
  channel  4     wall
  channel  5     zero markers on this cell
  channels 6-15  exactly 1..10 markers on this cell

Actions (reference `karel_env/karel.py:24-30`):
  0 move, 1 turnLeft, 2 turnRight, 3 pickMarker, 4 putMarker

Error model (reference `karel_env/karel.py:138-185`): with ``make_error=True``
moving into a wall or marker under/overflow raises ``KarelRuntimeError``; with
``make_error=False`` a blocked move turns the agent 180 degrees and marker
under/overflow is a no-op — in both non-error cases the action is still
recorded in the history.

This class is the *ground-truth semantics*: the vectorized on-device VM in
``ops/vm.py`` is property-tested against it.

Unlike the reference (which re-derives the agent location with np.where on
every query, `karel_env/karel.py:63-65`), we track the agent pose
incrementally; the observable behaviour is identical.
"""

import numpy as np

MAX_NUM_MARKER = 10
NUM_STATE_CHANNELS = 16

ACTION_NAMES = ["move", "turnLeft", "turnRight", "pickMarker", "putMarker"]
PERCEPTION_NAMES = [
    "frontIsClear", "leftIsClear", "rightIsClear",
    "markersPresent", "noMarkersPresent",
]

# facing: 0 north, 1 east, 2 south, 3 west — displacement (dy, dx)
_FRONT_DELTA = np.array([[-1, 0], [0, 1], [1, 0], [0, -1]], dtype=np.int64)
_LEFT_DELTA = np.array([[0, -1], [-1, 0], [0, 1], [1, 0]], dtype=np.int64)
_RIGHT_DELTA = np.array([[0, 1], [1, 0], [0, -1], [-1, 0]], dtype=np.int64)


class KarelRuntimeError(RuntimeError):
    """Raised on illegal actions when make_error=True."""


class KarelWorld:
    """Mutable Karel world with demonstration history recording."""

    def __init__(self, s=None, make_error=True):
        self.make_error = make_error
        if s is not None:
            self.set_new_state(s)

    # -- state management ---------------------------------------------------
    def set_new_state(self, s):
        self.s = np.asarray(s).astype(bool)
        self.h, self.w = self.s.shape[0], self.s.shape[1]
        ys, xs, ds = np.where(self.s[:, :, :4])
        if len(ys) != 1:
            raise ValueError("state must contain exactly one agent")
        self.y, self.x, self.d = int(ys[0]), int(xs[0]), int(ds[0])
        self.s_h = [self.s.copy()]
        self.a_h = []
        self.p_v_h = [self.get_perception_vector()]

    def clear_history(self):
        self.s_h = [self.s.copy()]
        self.a_h = []
        self.p_v_h = [self.get_perception_vector()]

    def _record(self, a_idx):
        # reference appends post-action state + action id + perception vector
        # (`karel_env/karel.py:56-60`)
        self.s_h.append(self.s.copy())
        self.a_h.append(a_idx)
        self.p_v_h.append(self.get_perception_vector())

    # -- geometry ------------------------------------------------------------
    def _neighbor(self, delta_table):
        dy, dx = delta_table[self.d]
        return self.y + dy, self.x + dx

    def _is_clear(self, ny, nx):
        if ny < 0 or ny >= self.h or nx < 0 or nx >= self.w:
            return False
        return not self.s[ny, nx, 4]

    # -- perception primitives (`karel_env/karel.py:97-132`) -----------------
    def front_is_clear(self):
        return self._is_clear(*self._neighbor(_FRONT_DELTA))

    def left_is_clear(self):
        return self._is_clear(*self._neighbor(_LEFT_DELTA))

    def right_is_clear(self):
        return self._is_clear(*self._neighbor(_RIGHT_DELTA))

    def marker_present(self):
        return bool(self.s[self.y, self.x, 6:].any())

    def no_marker_present(self):
        return not self.marker_present()

    def get_perception_vector(self):
        return np.array([
            self.front_is_clear(), self.left_is_clear(),
            self.right_is_clear(), self.marker_present(),
            self.no_marker_present(),
        ])

    def marker_count(self):
        # channel 5 encodes zero; channels 6..15 encode counts 1..10
        return int(np.argmax(self.s[self.y, self.x, 5:]))

    # -- state transition (`karel_env/karel.py:138-185`) ---------------------
    def state_transition(self, a_idx):
        a_idx = int(a_idx)
        if a_idx == 0:  # move
            if self.front_is_clear():
                ny, nx = self._neighbor(_FRONT_DELTA)
                self.s[self.y, self.x, self.d] = False
                self.s[ny, nx, self.d] = True
                self.y, self.x = ny, nx
            else:
                if self.make_error:
                    raise KarelRuntimeError("Failed to move.")
                # no-error mode: turn 180 degrees instead
                self.s[self.y, self.x, self.d] = False
                self.d = (self.d + 2) % 4
                self.s[self.y, self.x, self.d] = True
            self._record(a_idx)
        elif a_idx in (1, 2):  # turnLeft / turnRight
            # matches (a_idx * 2 - 3 + d) % 4: left = d-1, right = d+1
            self.s[self.y, self.x, self.d] = False
            self.d = (self.d + (a_idx * 2 - 3)) % 4
            self.s[self.y, self.x, self.d] = True
            self._record(a_idx)
        elif a_idx in (3, 4):  # pickMarker / putMarker
            count = self.marker_count()
            new_count = count + (a_idx * 2 - 7)  # pick: -1, put: +1
            if new_count < 0:
                if self.make_error:
                    raise KarelRuntimeError("No marker to pick up.")
                new_count = count
            elif new_count > MAX_NUM_MARKER - 1:
                # parity quirk: the reference caps at MAX_NUM_MARKER-1 == 9
                # markers (`karel_env/karel.py:174`), so putMarker on a cell
                # holding 9 markers raises even though channel 15 (10 markers)
                # exists. Replicated deliberately.
                if self.make_error:
                    raise KarelRuntimeError("Cannot put more marker.")
                new_count = count
            self.s[self.y, self.x, 5:] = False
            self.s[self.y, self.x, 5 + new_count] = True
            self._record(a_idx)
        else:
            raise KarelRuntimeError("Invalid action")


def batch_to_states(walls, markers, agent):
    """Expand ``generate_batch`` compact form to full (n, h, w, 16) bool
    state tensors (the ``KarelWorld`` input encoding)."""
    n, h, w = walls.shape
    s = np.zeros((n, h, w, NUM_STATE_CHANNELS), dtype=bool)
    s[:, :, :, 4] = walls
    s[:, :, :, 5:] = np.eye(MAX_NUM_MARKER + 1, dtype=bool)[markers]
    s[np.arange(n), agent[:, 0], agent[:, 1], agent[:, 2]] = True
    return s

"""Karel state rendering: ASCII and images.

Port of demo2program_tpu/tools/karel_render.py (`karel_env/karel_util.py:
30-97`): `state2str` / `state2symbol` draw the grid with ^>v< agent glyphs,
# walls and o markers, ANSI-coloured; `state2image` rasterises a state with
procedural tiles (walls brown, markers green, the agent a blue triangle
pointing where it faces) as an (h*g, w*g, 3) float RGB image in [0, 1].
"""

import numpy as np

_KAREL = "^>v<#"


class color_code:
    BLUE = "\033[94m"
    GREEN = "\033[92m"
    RED = "\033[91m"
    PURPLE = "\033[95m"
    END = "\033[0m"


def state2str(s, color=True):
    """(h, w, 16) bool state -> multi-line string."""
    def paint(code, ch):
        return f"{code}{ch}{color_code.END}" if color else ch

    lines = []
    for i in range(s.shape[0]):
        row = ""
        for j in range(s.shape[1]):
            if s[i, j, :4].sum() > 0 and s[i, j, 6:].sum() > 0:
                row += paint(color_code.PURPLE, _KAREL[np.argmax(s[i, j])])
            elif s[i, j, :4].sum() > 0:
                row += paint(color_code.BLUE, _KAREL[np.argmax(s[i, j])])
            elif s[i, j, 4] > 0:
                row += paint(color_code.RED, "#")
            elif s[i, j, 6:].sum() > 0:
                row += paint(color_code.GREEN, "o")
            else:
                row += "."
        lines.append(row)
    return "\n".join(lines)


def state2symbol(s):
    """Print the ASCII rendering (the reference's API)."""
    print(state2str(s))


def _tile(grid_size, rgb):
    t = np.ones((grid_size, grid_size, 3))
    t[1:-1, 1:-1] = rgb
    return t


def _agent_tile(grid_size, d, marker):
    """Procedural agent tile: a triangle pointing in direction d (0 north,
    1 east, 2 south, 3 west), on a light green ground over a marker."""
    t = np.ones((grid_size, grid_size, 3))
    if marker:
        t[:] = (0.8, 1.0, 0.8)
    g = grid_size
    yy, xx = np.mgrid[0:g, 0:g]
    cy = cx = (g - 1) / 2
    if d == 0:
        m = np.abs(xx - cx) <= (yy / 2)
    elif d == 2:
        m = np.abs(xx - cx) <= ((g - 1 - yy) / 2)
    elif d == 1:
        m = np.abs(yy - cy) <= ((g - 1 - xx) / 2)
    else:
        m = np.abs(yy - cy) <= (xx / 2)
    t[m] = (0.1, 0.2, 0.9)
    return t


def state2image(s, grid_size=10):
    """(h, w, 16) state -> (h*g, w*g, 3) float image in [0, 1]."""
    h, w = s.shape[0], s.shape[1]
    img = np.ones((h * grid_size, w * grid_size, 3))
    wall_t = _tile(grid_size, (0.45, 0.25, 0.15))
    marker_t = _tile(grid_size, (0.2, 0.8, 0.2))

    def put(y, x, tile):
        img[y * grid_size:(y + 1) * grid_size,
            x * grid_size:(x + 1) * grid_size] = tile

    for y, x in zip(*np.where(s[:, :, 4])):
        put(y, x, wall_t)
    for y, x in zip(*np.where(s[:, :, 6:].sum(axis=-1) > 0)):
        put(y, x, marker_t)
    ys, xs = np.where(s[:, :, :4].sum(axis=-1) > 0)
    if len(ys) == 1:
        y, x = int(ys[0]), int(xs[0])
        d = int(np.argmax(s[y, x, :4]))
        put(y, x, _agent_tile(grid_size, d, s[y, x, 6:].sum() > 0))
    elif len(ys) > 1:
        raise ValueError("more than one agent in state")
    return img

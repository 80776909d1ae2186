"""Karel state rendering, ASCII.

Port of `state2str` / `state2symbol` of demo2program_tpu/tools/karel_render.py
(`karel_env/karel_util.py:30-97`): the grid with ^>v< agent glyphs, # walls
and o markers, ANSI-coloured. The image rasteriser is not ported.
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

"""Console logger with an extra INFOV ("info, verbose-highlight") level.

The port's own copy of demo2program_tpu/utils/logger.py (numpy and
the standard library only), so the port imports nothing of the JAX
package.

Parity target: the colorlog logger in the reference (models/util.py:11-48),
which defines a custom INFOV level between INFO and WARNING and colorized
output. We use plain logging with ANSI colors (no colorlog dependency).
"""

import logging

_INFOV = 25  # above INFO, below WARNING, like the reference's INFOV

_COLORS = {
    logging.DEBUG: "\033[37m",     # white
    _INFOV: "\033[96m",            # bright cyan
    logging.INFO: "\033[94m",      # blue-ish
    logging.WARNING: "\033[93m",   # yellow
    logging.ERROR: "\033[91m",     # red
    logging.CRITICAL: "\033[95m",  # magenta
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelno, "")
        return f"{color}{msg}{_RESET}" if color else msg


class _Logger(logging.Logger):
    def infov(self, msg, *args, **kwargs):
        if self.isEnabledFor(_INFOV):
            self._log(_INFOV, msg, args, **kwargs)

    # the reference aliases warn() (models/util.py usage across trainer.py)
    def warn(self, msg, *args, **kwargs):  # noqa: A003
        self.warning(msg, *args, **kwargs)


logging.addLevelName(_INFOV, "INFOV")
logging.setLoggerClass(_Logger)

log = logging.getLogger("demo2program_tpu_torch")
if not log.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(
        _ColorFormatter("[%(levelname)s %(asctime)s] %(message)s", "%H:%M:%S"))
    log.addHandler(_handler)
    log.setLevel(logging.INFO)
    log.propagate = False

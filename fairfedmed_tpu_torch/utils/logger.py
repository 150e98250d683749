"""stdout tee to ``OUTPUT_DIR/log.txt`` (the port's own copy of the JAX
package's ``utils/logger.py``; mirrors Dassl/dassl/utils/logger.py:12-73)."""

from __future__ import annotations

import os
import sys
import time


class Logger:
    """Writes to console and to a file simultaneously."""

    def __init__(self, fpath: str | None = None):
        self.console = sys.stdout
        self.file = None
        if fpath is not None:
            os.makedirs(os.path.dirname(fpath), exist_ok=True)
            self.file = open(fpath, "w")

    def __del__(self):
        self.close()

    def write(self, msg):
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)
            if "\n" in msg:
                # line-buffer the file so a killed run keeps its log tail
                self.file.flush()

    def flush(self):
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self):
        """Flush the console and close the file; later calls do nothing (the
        console may be closed by then)."""
        if self.file is not None:
            self.console.flush()
            self.file.close()
            self.file = None


def setup_logger(output: str | None = None) -> None:
    """Replace ``sys.stdout`` by a :class:`Logger` that also writes
    ``output/log.txt`` (or ``output`` itself when it names a .txt/.log file);
    an existing log is kept and the new one gets a timestamp suffix."""
    if output is None:
        return
    if output.endswith(".txt") or output.endswith(".log"):
        fpath = output
    else:
        fpath = os.path.join(output, "log.txt")
    if os.path.exists(fpath):
        fpath += time.strftime("-%Y-%m-%d-%H-%M-%S")
    sys.stdout = Logger(fpath)

"""Per-subsystem console printing and a frame progress bar.

Counterpart of ``glorie_slam_tpu/utils/printer.py``: one object in the
process (no printer process), coloured prefixes per subsystem, and a tqdm
frame counter where tqdm imports.
"""

import sys

_COLOR = {"tracker": "\033[0;34m", "mapper": "\033[0;32m",
          "info": "\033[0;36m", "error": "\033[0;31m",
          "eval": "\033[0;35m", "pcl": "\033[0;33m"}
_PREFIX = {"tracker": "[Tracker]", "mapper": "[Mapper]", "info": "[Info]",
           "error": "[Error]", "eval": "[Eval]", "pcl": "[PCL]"}
_END = "\033[0m"


class Printer:
    def __init__(self, total_frames: int = 0, silence: bool = False):
        self.silence = silence
        self._pbar = None
        if not silence and total_frames > 0:
            try:
                from tqdm import tqdm
            except ImportError:
                tqdm = None
            if tqdm is not None:
                self._pbar = tqdm(total=total_frames, desc="frames",
                                  dynamic_ncols=True)

    def print(self, msg, subsystem="info"):
        if self.silence:
            return
        text = (f"{_COLOR.get(subsystem, _COLOR['info'])}"
                f"{_PREFIX.get(subsystem, '[Info]')} {msg}{_END}")
        if self._pbar is not None:
            self._pbar.write(text)
        else:
            print(text, file=sys.stderr)

    def update_pbar(self, n=1):
        if self._pbar is not None:
            self._pbar.update(n)

    def terminate(self):
        if self._pbar is not None:
            self._pbar.close()

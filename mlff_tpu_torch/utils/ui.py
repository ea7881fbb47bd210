"""Terminal progress / formatting utilities.

A verbatim copy of ``mlff_tpu.utils.ui`` (pure stdlib), so that the port
imports nothing of the JAX package and prints the same strings for the same
input.  Rebuild of the reference's ANSI console protocol (reference:
sgdml/utils/ui.py:60-489) for a chunked solver: progress events arrive per
chunk of PCG iterations (``solvers.cg``), not per Python-loop item, so the
bar maps *convergence* (log-residual position between ||b|| and the
stopping threshold) rather than a raw item count.  All escape-code output
is TTY-gated: piped or logged runs get plain, rate-limited lines instead of
``\\r`` rewrites.

API compatibility: ``callback(current, total, disp_str, sec_disp_str,
done_with_warning, newline_when_done)`` and ``sec_callback`` keep the
reference's calling convention.
"""

from __future__ import annotations

import math
import os
import shutil
import sys
import time

# -- colors -----------------------------------------------------------------

BLACK, RED, GREEN, YELLOW, BLUE, MAGENTA, CYAN, WHITE = range(8)
_RESET = "\x1b[0m"


def _tty(stream=None) -> bool:
    if os.environ.get("MLFF_TPU_FORCE_TTY"):
        return os.environ["MLFF_TPU_FORCE_TTY"] != "0"
    stream = stream or sys.stdout
    return hasattr(stream, "isatty") and stream.isatty()


def color_str(s: str, fore_color: int = WHITE, back_color: int = BLACK,
              bold: bool = False) -> str:
    if not _tty():
        return s
    return "\x1b[{};{};{}m{}{}".format(
        1 if bold else 0, 30 + fore_color, 40 + back_color, s, _RESET)


def white_bold_str(s: str) -> str:
    return color_str(s, WHITE, bold=True)


def gray_str(s: str) -> str:
    return "\x1b[90m{}{}".format(s, _RESET) if _tty() else s


def underline_str(s: str) -> str:
    return "\x1b[4m{}{}".format(s, _RESET) if _tty() else s


def blink_str(s: str) -> str:
    return "\x1b[5m{}{}".format(s, _RESET) if _tty() else s


def info_str(s: str) -> str:
    return color_str(s, CYAN)


def pass_str(s: str) -> str:
    return color_str(s, GREEN)


def warn_str(s: str) -> str:
    return color_str(s, YELLOW, bold=True)


def fail_str(s: str) -> str:
    return color_str(s, RED, bold=True)


# -- reference-compatible progress callback ---------------------------------

MAX_PRINT_WIDTH = 100
_last_pct: dict = {"pct": -1}


def callback(current, total=1, disp_str="", sec_disp_str=None,
             done_with_warning=False, newline_when_done=True) -> None:
    """Progress (``[ 45%] desc``) or toggle (``[ .. ]``/``[DONE]``) line.

    Reference protocol (ui.py:60-131); here the in-place ``\\r`` rewrite only
    happens on a TTY — otherwise lines are emitted at 10% steps so batch
    logs stay readable.
    """
    is_toggle = total == 1
    is_done = abs(float(current) - float(total)) < 1e-12

    tty = _tty()
    if is_toggle:
        if is_done:
            flag = warn_str("[WARN]") if done_with_warning else pass_str("[DONE]")
        else:
            flag = info_str("[" + blink_str(" .. ") + "]")
    else:
        pct = int(float(current) * 100 / float(total))
        if not is_done:
            step = 1 if tty else 10
            if pct // step == _last_pct["pct"] // step and _last_pct["pct"] >= 0:
                return
        _last_pct["pct"] = -1 if is_done else pct
        flag = (pass_str if is_done else info_str)("[{:3d}%]".format(pct))

    line = "{} {}".format(flag, disp_str)
    if sec_disp_str:
        pad = max(1, MAX_PRINT_WIDTH - _visible_len(line) - _visible_len(sec_disp_str))
        line += " " * pad + gray_str(sec_disp_str)

    if tty:
        sys.stdout.write("\r" + line)
        if is_done and newline_when_done:
            sys.stdout.write("\n")
    else:
        sys.stdout.write(line + "\n")
    sys.stdout.flush()


def sec_callback(current, total=1, disp_str=None, sec_disp_str=None,
                 main_callback=None, **kwargs) -> None:
    """Route a subtask's progress into a parent callback's gray secondary
    field (reference ui.py:136-158)."""
    assert main_callback is not None
    if total == 1:
        state = "DONE" if abs(float(current) - 1.0) < 1e-12 else " .. "
        sec = "{} | {}".format(disp_str, state)
    else:
        sec = "{} | {:3d}%".format(disp_str, int(float(current) * 100 / total))
    main_callback(0, sec_disp_str=sec, **kwargs)


def _visible_len(s: str) -> int:
    """Length excluding ANSI escape sequences."""
    n, i = 0, 0
    while i < len(s):
        if s[i] == "\x1b":
            while i < len(s) and s[i] != "m":
                i += 1
            i += 1
        else:
            n += 1
            i += 1
    return n


# -- convergence-mapped solver progress -------------------------------------

class SolverProgress:
    """Progress display for the chunked PCG loop.

    Designed for ``solvers.cg``'s callback protocol ``(num_iters, resid,
    eff)``: one event per device chunk.  The bar position is the LOG-residual
    trajectory — ``log(r0 / r) / log(r0 / threshold)`` — i.e. the fraction of
    the convergence distance covered, which is the quantity CG actually
    drives down linearly (per-iteration counts are unbounded a priori, so a
    count-based bar cannot exist).  Also shows iterations/s over a sliding
    window and the solver-effectiveness signal.

    Use as the ``callback=`` argument of ``Trainer.train`` /
    ``solve_iterative``::

        prog = SolverProgress(tol=1e-4, label="ethanol n=31k")
        Trainer().train(task, callback=prog)
        prog.close(converged=True)
    """

    def __init__(self, tol: float = 1e-4, label: str = "cg",
                 stream=None):
        self.tol = float(tol)
        self.label = label
        self.stream = stream or sys.stdout
        self._r0 = None
        self._t0 = None
        self._last = None  # (t, it) for the rate window
        self._done = False

    def __call__(self, num_iters: int, resid: float, eff: int = 0) -> None:
        now = time.monotonic()
        if self._r0 is None:
            self._r0 = max(float(resid), 1e-300)
            self._t0 = now
            self._last = (now, num_iters)
        frac = 0.0
        if resid > 0 and self._r0 > 0:
            denom = -math.log(self.tol)  # r0 -> tol * ||b|| ~ tol * r0
            if denom > 0:
                frac = min(1.0, max(0.0, math.log(self._r0 / resid) / denom))
        t_prev, it_prev = self._last
        rate = (num_iters - it_prev) / max(now - t_prev, 1e-9) \
            if num_iters > it_prev else 0.0
        self._last = (now, num_iters)
        sec = "it {:d}  resid {:.2e}  {:.0f} it/s  eff {:+d}".format(
            num_iters, float(resid), rate, int(eff))
        self._emit(frac, sec)

    def _emit(self, frac: float, sec: str) -> None:
        width = min(MAX_PRINT_WIDTH,
                    shutil.get_terminal_size((80, 20)).columns)
        barw = max(10, width - len(self.label) - len(sec) - 12)
        fill = int(frac * barw)
        bar = "=" * fill + (">" if fill < barw else "") + \
              " " * max(0, barw - fill - 1)
        line = "{} [{}] {:3d}%  {}".format(
            self.label, bar, int(frac * 100), gray_str(sec))
        if _tty(self.stream):
            self.stream.write("\r" + line)
        else:
            self.stream.write(line + "\n")
        self.stream.flush()

    def close(self, converged: bool = True) -> None:
        if self._done:
            return
        self._done = True
        dt = 0.0 if self._t0 is None else time.monotonic() - self._t0
        tag = pass_str("[DONE]") if converged else warn_str("[WARN]")
        if _tty(self.stream):
            self.stream.write("\n")
        self.stream.write("{} {} ({:.1f}s)\n".format(tag, self.label, dt))
        self.stream.flush()


# -- prompts and pretty printers --------------------------------------------

def yes_or_no(question: str) -> bool:
    """y/n prompt; re-asks on anything else (reference ui.py:38-57)."""
    while True:
        reply = input(question + " (y/n): ").strip().lower()
        if reply in ("y", "yes"):
            return True
        if reply in ("n", "no"):
            return False


def gen_lattice_str(lat) -> str:
    """Pretty 3x3 lattice block with an 'a b c =' left gutter."""
    import numpy as np

    lat = np.asarray(lat)
    rows = []
    for label, row in zip("abc", lat):
        rows.append("{} = [{}]".format(
            label, " ".join("{:11.4f}".format(v) for v in row)))
    return "\n".join(rows)


def gen_mat_str(mat) -> str:
    """Aligned fixed-point matrix block (reference ui.py:367-420)."""
    import numpy as np

    mat = np.asarray(mat)
    if mat.ndim == 1:
        mat = mat[None, :]
    cols = []
    for j in range(mat.shape[1]):
        col = ["{:.4f}".format(v).rstrip("0").rstrip(".") for v in mat[:, j]]
        w = max(len(c) for c in col)
        cols.append([c.rjust(w) for c in col])
    return "\n".join(
        " ".join(cols[j][i] for j in range(mat.shape[1]))
        for i in range(mat.shape[0]))


def gen_range_str(lo, hi) -> str:
    """Compact '[lo, hi]' range descriptor."""
    return "[{:g}, {:g}]".format(float(lo), float(hi))


def wrap_str(s: str, width: int = MAX_PRINT_WIDTH) -> str:
    import textwrap

    return "\n".join(textwrap.wrap(s, width=width) or [""])


def indent_str(s: str, indent: int) -> str:
    pad = " " * indent
    return "\n".join(pad + line for line in s.split("\n"))


def print_step_title(title: str, sec_title: str = "",
                     underscore: bool = True) -> None:
    line = white_bold_str(title.upper())
    if sec_title:
        line += " " + gray_str(sec_title)
    print(line)
    if underscore:
        print("-" * min(MAX_PRINT_WIDTH, max(len(title), 8)))

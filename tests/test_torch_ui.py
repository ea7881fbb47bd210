"""The port's progress UI (mlff_tpu_torch/utils/ui.py) against the JAX
package's: every test of tests/test_ui.py, run on both modules with the same
input; the printed strings and returned values must be equal, and the
port's output must pass the original test's checks.  ``SolverProgress``
reads a clock for its rate: both runs get the same fake clock."""

import io as _io
import itertools
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from mlff_tpu.utils import ui as jui  # noqa: E402
from mlff_tpu_torch.utils import ui  # noqa: E402


@pytest.fixture(autouse=True)
def _no_tty(monkeypatch):
    """Default every test to non-TTY mode (deterministic plain output)."""
    monkeypatch.setenv("MLFF_TPU_FORCE_TTY", "0")
    ui._last_pct["pct"] = -1
    jui._last_pct["pct"] = -1


def _both(capsys, fn):
    """fn(module) on the JAX module, then on the port's: (port's stdout,
    port's return value), after checking both against the JAX module's."""
    out = []
    for mod in (jui, ui):
        ret = fn(mod)
        out.append((capsys.readouterr().out, ret))
    assert out[1] == out[0]
    return out[1]


def test_callback_toggle_done(capsys):
    out, _ = _both(capsys, lambda m: m.callback(1, 1, "building"))
    assert "[DONE]" in out and "building" in out


def test_callback_toggle_warn(capsys):
    out, _ = _both(capsys, lambda m: m.callback(1, 1, "building",
                                                done_with_warning=True))
    assert "[WARN]" in out


def test_callback_percent_and_rate_limit(capsys):
    def run(m):
        m.callback(10, 100, "assembly")
        m.callback(11, 100, "assembly")  # same 10%-bucket: suppressed
        m.callback(50, 100, "assembly")
        m.callback(100, 100, "assembly")

    out, _ = _both(capsys, run)
    assert "[ 10%]" in out
    assert "[ 11%]" not in out
    assert "[ 50%]" in out
    assert "[100%]" in out


def test_callback_secondary_string(capsys):
    out, _ = _both(capsys, lambda m: m.callback(1, 1, "task",
                                                sec_disp_str="extra info"))
    assert "extra info" in out


def test_sec_callback_routes_to_main(capsys):
    def run(m):
        events = []
        m.sec_callback(50, 100, disp_str="sub",
                       main_callback=lambda c, sec_disp_str:
                       events.append(sec_disp_str))
        return events

    _, events = _both(capsys, run)
    assert events == ["sub |  50%"]


FORMATTERS = ("info_str", "pass_str", "warn_str", "fail_str", "gray_str",
              "white_bold_str", "underline_str")


def test_colors_plain_without_tty(capsys):
    _, got = _both(capsys, lambda m: [getattr(m, f)("x") for f in FORMATTERS])
    assert got == ["x"] * len(FORMATTERS)


def test_colors_escape_with_tty(monkeypatch, capsys):
    monkeypatch.setenv("MLFF_TPU_FORCE_TTY", "1")
    _, got = _both(capsys, lambda m: [getattr(m, f)("ok") for f in FORMATTERS]
                   + [m._visible_len(m.pass_str("ok"))])
    s = got[1]
    assert s.startswith("\x1b[") and s.endswith("\x1b[0m") and "ok" in s
    assert got[-1] == 2


def _progress(m, events, converged=True, tol=1e-4, label="cg-test"):
    """SolverProgress on a fake clock (one second per reading)."""
    clock = itertools.count(100.0)
    real = time.monotonic
    time.monotonic = lambda: float(next(clock))
    try:
        buf = _io.StringIO()
        prog = m.SolverProgress(tol=tol, label=label, stream=buf)
        for args in events:
            prog(*args)
        prog.close(converged=converged)
    finally:
        time.monotonic = real
    return buf.getvalue()


def test_solver_progress_convergence_fraction(capsys):
    events = [(10, 1.0, 100),     # r0 = 1.0 -> 0%
              (20, 1e-2, 80),     # half the log-distance -> 50%
              (30, 1e-4, 60)]     # at tol -> 100%
    _, out = _both(capsys, lambda m: _progress(m, events))
    assert "  0%" in out and " 50%" in out and "100%" in out
    assert "[DONE] cg-test" in out
    # events carry iteration counts, residuals and the rate
    assert "it 20" in out and "1.00e-02" in out and "10 it/s" in out


def test_solver_progress_warn_on_unconverged(capsys):
    _, out = _both(capsys, lambda m: _progress(m, [(5, 1.0)],
                                               converged=False, label="x"))
    assert "[WARN]" in out


def test_solver_progress_takes_the_pcg_callback():
    """The port's pcg calls callback(it_after, resid_now, eff) once per
    chunk: SolverProgress is that callback (the CLI's train verb)."""
    import torch

    from mlff_tpu_torch.solvers.cg import pcg

    buf = _io.StringIO()
    prog = ui.SolverProgress(tol=1e-8, label="pcg", stream=buf)
    A = torch.diag(torch.linspace(1.0, 10.0, 60, dtype=torch.float64))
    res = pcg(lambda v: A @ v, torch.ones(60, dtype=torch.float64),
              tol=1e-8, chunk=5, callback=prog)
    prog.close(converged=res.converged)
    lines = buf.getvalue().splitlines()
    assert len(lines) == -(-res.num_iters // 5) + 1
    assert f"it {res.num_iters} " in lines[-2] and "resid" in lines[-2]
    assert lines[-1].startswith("[DONE] pcg")


def test_gen_lattice_str(capsys):
    _, s = _both(capsys, lambda m: m.gen_lattice_str(np.eye(3) * 2.5))
    assert s.count("\n") == 2
    assert s.splitlines()[0].startswith("a = [")
    assert "2.5000" in s


def test_gen_mat_str_alignment(capsys):
    _, s = _both(capsys, lambda m: m.gen_mat_str(
        np.array([[1.0, -2.25], [33.5, 0.1]])))
    lines = s.splitlines()
    assert len(lines) == 2
    # columns right-aligned: equal visible widths
    assert len(lines[0]) == len(lines[1])


def test_gen_range_str(capsys):
    _, s = _both(capsys, lambda m: m.gen_range_str(0.5, 2.0))
    assert s == "[0.5, 2]"


def test_wrap_and_indent(capsys):
    _, (s, ind) = _both(capsys, lambda m: (m.wrap_str("word " * 40, width=20),
                                           m.indent_str("a\nb", 3)))
    assert all(len(line) <= 20 for line in s.splitlines())
    assert ind == "   a\n   b"


def test_print_step_title(capsys):
    out, _ = _both(capsys, lambda m: m.print_step_title("training",
                                                        "sig = 10"))
    assert out.splitlines()[0] == "TRAINING sig = 10"

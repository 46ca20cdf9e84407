"""``cli fit``'s summary line held to the JAX CLI's in every fit mode: the
same scene, shift and steps through ``python_ray_tracer_tpu.cli fit --backend
jnp`` and the port's ``cli fit --backend torch`` print the same ``loss:`` line,
number for number within the stated tolerances, and log the same losses."""
import re

import numpy as np
import pytest
import torch

from python_ray_tracer_tpu import cli as jcli
from python_ray_tracer_tpu_torch import cli

torch.set_num_threads(1)
NUMBER = re.compile(r"[-+]?\d+\.\d+(?:e[-+]\d+)?")


def _loss_line(text):
    return next(ln for ln in text.splitlines() if ln.startswith("loss: "))


def _logged_losses(text):
    """Each ``[fit] step N: ... loss=X`` line's step and full-precision loss."""
    return [(int(m.group(1)), float(m.group(2)))
            for m in re.finditer(r"^\[fit\] step (\d+):.*?\bloss=(\S+)", text, re.M)]


def _loss_close(a, b, rel):
    """``a`` and ``b``, printed as ``.3e``, stand for values within ``rel`` of
    each other: each print rounds by half a unit of its 4th digit."""
    if b == 0.0:
        return a == 0.0
    unit = 10.0 ** (np.floor(np.log10(abs(b))) - 3)
    return abs(a - b) <= rel * abs(b) + unit


# id: mode, extra flags, steps, loss rel tolerance, error tolerance. The
# default hard and soft scenes hold 2 and 6 spheres, an even count. Of the
# random scene of --spheres 15 (an odd count) one sphere lies in the 24x24
# view, of 16 (even) two; with fewer than 15 none does, and the fit is void.
CASES = {
    "hard": ("hard", [], 12, 1e-3, 2e-4),
    "camera": ("camera", [], 12, 1e-4, 1e-4),
    "soft": ("soft", [], 6, 1e-4, 2e-4),
    "hard-15-spheres": ("hard", ["--spheres", "15"], 12, 1e-3, 2e-4),
    "soft-16-spheres": ("soft", ["--spheres", "16"], 6, 1e-4, 2e-4),
}


@pytest.mark.parametrize("mode,extra,steps,loss_rel,err_tol", list(CASES.values()),
                         ids=list(CASES))
def test_cli_fit_summary_matches_jax_cli(capsys, mode, extra, steps, loss_rel, err_tol):
    """At 24x24, depth 1: the summary's losses within ``loss_rel``, its center
    (or camera position) errors, the median among them, within ``err_tol``,
    the same words around them, and every logged loss within ``loss_rel``."""
    args = ["fit", "--mode", mode, "--width", "24", "--height", "24", "--depth", "1",
            "--steps", str(steps), "--out", ""] + extra
    assert jcli.main(args + ["--backend", "jnp"]) == 0
    want = capsys.readouterr().out
    assert cli.main(args + ["--backend", "torch"]) == 0
    got = capsys.readouterr().out

    line_w, line_g = _loss_line(want), _loss_line(got)
    assert NUMBER.sub("#", line_g) == NUMBER.sub("#", line_w), (line_g, line_w)
    nums_w = [float(v) for v in NUMBER.findall(line_w)]
    nums_g = [float(v) for v in NUMBER.findall(line_g)]
    assert len(nums_g) == len(nums_w) == (4 if mode == "camera" else 5), line_w
    for a, b in zip(nums_g[:2], nums_w[:2]):
        assert _loss_close(a, b, loss_rel), (line_g, line_w)
    assert nums_g[2] == nums_w[2], (line_g, line_w)          # the starting error
    for a, b in zip(nums_g[3:], nums_w[3:]):
        assert abs(a - b) <= err_tol + 1e-9, (line_g, line_w)

    logged_w, logged_g = _logged_losses(want), _logged_losses(got)
    assert [s for s, _ in logged_g] == [s for s, _ in logged_w] and logged_w, (got, want)
    for (_, a), (_, b) in zip(logged_g, logged_w):
        assert a == pytest.approx(b, rel=loss_rel), (got, want)


def test_center_err_span_takes_numpys_median():
    """For an even count the median is the mean of the two middle errors, as
    ``np.median`` in the JAX CLI gives it, not ``torch.median``'s lower one."""
    errs = torch.tensor([0.0885, 0.2645])
    span = cli._center_err_span(0.2, errs)
    assert span == "center err: 0.200 -> median 0.1765 / max 0.2645"
    assert float(np.median(errs.numpy())) == pytest.approx(0.1765, abs=1e-7)
    assert float(errs.median()) == pytest.approx(0.0885)
    odd = torch.tensor([0.3, 0.1, 0.2])
    assert cli._center_err_span(0.2, odd) == "center err: 0.200 -> median 0.2000 / max 0.3000"

"""The runner that the SuperPoint front-end benchmarks share
(`bench_sp_front`, `bench_sp_score`, `bench_sp_variants`).

A benchmark is a list of `Form`s: one call of one form of a computation
(`models.superpoint_variants`). A form with a `ref` must give the output
of the form of that label, which comes earlier in the list, within its
tolerance. `run_forms` checks each form, counts the kernel launches of one
call, and times it (`utils.profiling.time_windows`); it runs under
inference mode with TF32 off, so that an fp32 form is fp32 throughout.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable

import torch

from onepose_tpu_torch.models.superpoint_variants import max_abs, rel_to_max
from onepose_tpu_torch.ops.kernels import launch_counts
from onepose_tpu_torch.utils.precision import fp32_matmuls
from onepose_tpu_torch.utils.profiling import card_line, time_windows


@dataclass
class Form:
    """section / label: what the row is; fn: one timed call; ref: the label
    of the form whose output this one must give (None: a reference);
    tols: {output key: (tolerance, relative to the largest |ref|)}; out:
    the outputs compared, a dict of tensors (default {"out": fn()});
    kernels: the kernel launches of one call on the card."""

    section: str
    label: str
    fn: Callable
    ref: str | None = None
    tols: dict = field(default_factory=dict)
    out: Callable | None = None
    kernels: dict = field(default_factory=dict)


def _outputs(form: Form) -> dict:
    out = form.out() if form.out is not None else form.fn()
    return out if isinstance(out, dict) else {"out": out}


def run_forms(forms: list, device: torch.device, iters: int, windows: int,
              warmup: int = 3) -> list:
    """One row a form: section, form, ref, err and tol by output key, the
    launches of one call, ok (within every tolerance, and the launches
    those of `kernels` on the card: none on the CPU), and the times of
    `time_windows`."""
    wanted = {f.ref for f in forms if f.ref}
    kept, rows = {}, []
    cuda = device.type == "cuda"
    with torch.inference_mode(), fp32_matmuls():
        for f in forms:
            out = _outputs(f)
            err = {}
            if f.ref is not None:
                ref = kept[f.ref]
                err = {k: (rel_to_max if rel else max_abs)(out[k], ref[k])
                       for k, (tol, rel) in f.tols.items()}
            if f.label in wanted:
                kept[f.label] = out
            del out
            before = launch_counts()
            f.fn()
            if cuda:
                torch.cuda.synchronize(device)
            launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
            ok = all(err[k] <= tol for k, (tol, _) in f.tols.items()) and \
                launches == (f.kernels if cuda else {})
            rows.append({"section": f.section, "form": f.label, "ref": f.ref, "err": err,
                         "tol": {k: [tol, "of max" if rel else "abs"]
                                 for k, (tol, rel) in f.tols.items()},
                         "launches": launches, "ok": ok,
                         **time_windows(f.fn, device, iters, windows, warmup)})
    return rows


def row_line(row: dict) -> str:
    """One printed line of a row: times, spread, error against its tolerance, launches."""
    err = ", ".join(f"{k} {row['err'][k]:.3e} (<= {t} {kind})"
                    for k, (t, kind) in row["tol"].items())
    return (f"{row['section']}: {row['form']}: {row['ms']:.4f} ms a call (windows "
            f"{row['min_ms']:.4f} .. {row['max_ms']:.4f})"
            + (f", against {row['ref']!r}: {err}" if row["ref"] else "")
            + f", launches {row['launches']}" + ("" if row["ok"] else "  FAILED"))


def card(device: torch.device) -> str:
    """The card's nvidia-smi line, or what a CPU run's times are."""
    return card_line() if device.type == "cuda" else "cpu (host clock: not a card time)"


def report(name: str, result: dict) -> int:
    """Print the rows and, last, {name: result}; 0 if every row is ok."""
    for row in result["rows"]:
        print(row_line(row), flush=True)
    print(json.dumps({name: result}), flush=True)
    return 0 if all(r["ok"] for r in result["rows"]) else 1

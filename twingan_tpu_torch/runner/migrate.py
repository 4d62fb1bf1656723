"""Cross-stage checkpoint migration over the port's flat train state.

Counterpart of ``twingan_tpu/runner/migrate.py``. When the resolution
doubles, the new stage's fresh state is a superset of the last stage's
(the layer names do not change with growth): migrating copies every leaf
whose path AND shape match, and keeps the fresh init elsewhere (the new
blocks, their to_rgb/from_rgb layers and their optimizer slots). The
top-level counters in ``RESET_PATHS`` restart from the template's zeros.
Everything else that matches carries, the optimizers' update counts
included: they are leaves of shape () below ``gen_opt_state`` and
``dis_opt_state``, not top-level paths, exactly as in the JAX function.

A state here is the flat dict of ``train.state.state_to_dict``: keys are
the JAX state-dict paths joined with ``/`` (``params/generator/
block_4_conv0/conv/kernel``, ``gen_opt_state/0/mu/...``), values tensors.
The report lists paths in that form, so a ``checkpoint_exclude_scopes``
written for the JAX runner selects the same leaves: a prefix of the joined
path, or an exact path segment, never a bare substring.
"""

from __future__ import annotations

from typing import Any, Mapping

# Top-level paths that must NOT carry across stages (fresh counters).
RESET_PATHS = ("step", "critic_step", "gen_loss_ema", "gdrop_strength")


def _shape(x: Any) -> tuple:
    return tuple(getattr(x, "shape", ()))


def excluded(path: str, scopes) -> bool:
    """``path`` lies under one of ``scopes``: a prefix of the joined path,
    or one whole segment of it."""
    parts = path.split("/")
    return any(path.startswith(s) or s in parts for s in scopes)


def migrate_state_dict(
    template: Mapping[str, Any],
    restored: Mapping[str, Any],
    reset_paths: tuple = RESET_PATHS,
    strict_unused: bool = False,
    exclude_scopes: tuple = (),
) -> tuple[dict, dict]:
    """Copy restored leaves into the template wherever path and shape
    match. Returns (migrated flat dict, report), the report listing the
    ``carried``, ``fresh``, ``dropped`` and ``shape_mismatch`` paths."""
    report = {"carried": [], "fresh": [], "dropped": [], "shape_mismatch": []}
    out = dict(template)
    for path, tval in template.items():
        if path.split("/", 1)[0] in reset_paths or (
                exclude_scopes and excluded(path, exclude_scopes)):
            report["fresh"].append(path)
            continue
        rval = restored.get(path)
        if rval is None:
            report["fresh"].append(path)
            continue
        if _shape(tval) != _shape(rval):
            report["shape_mismatch"].append(f"{path}: {_shape(rval)} -> {_shape(tval)}")
            continue
        out[path] = rval
        report["carried"].append(path)
    report["dropped"] = [p for p in restored if p not in template]
    if strict_unused and report["dropped"]:
        raise ValueError(f"restored leaves with no destination: {report['dropped'][:10]}")
    return out, report

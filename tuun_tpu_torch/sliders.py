"""Slider system (port of reference/src/lib/slider.rs): normalized
[0,1] controller positions map to values through a linear range or a
user-defined Tuun function, bind into program scope as
Marked(Slider(label), Const(v)), and live updates splice one-buffer linear
ramps under the mark."""

from __future__ import annotations

from typing import List, Sequence

from . import builtins as builtins_mod
from . import eval as eval_mod
from . import ir, parser
from .expr import (EFloat, EWaveform, Slider, SliderFunction, SliderLinear,
                   SliderUserDefined, SourceBinding, TuunError, definition)


def denormalize(function: SliderFunction, normalized: float) -> float:
    """Linear: min + t(max-min). UserDefined: evaluates the Tuun function
    (slider.rs:25-55). Errors yield 0.0 at call sites (matching unwrap_or)."""
    if isinstance(function, SliderLinear):
        return function.min + normalized * (function.max - function.min)
    if isinstance(function, SliderUserDefined):
        source = f"({function.function_source})({normalized})"
        expr = parser.parse_program(source)
        bindings: List[SourceBinding] = []
        builtins_mod.add_bindings(bindings)

        def resolve(path):
            raise TuunError("didn't expect to resolve inside of slider function")
        result = eval_mod.evaluate(resolve, bindings, expr)
        if isinstance(result, EFloat):
            return result.value
        raise TuunError("slider function did not return a number")
    raise TypeError(type(function))


def denormalize_or_zero(function: SliderFunction, normalized: float) -> float:
    try:
        return denormalize(function, normalized)
    except Exception:
        return 0.0


def append_slider_bindings(configs: Sequence[Slider],
                           normalized_values: Sequence[float],
                           mark_id_fn, bindings: List[SourceBinding]) -> None:
    """Binds each slider label to Marked(Slider(label), Const(value))
    (slider.rs:57-81)."""
    for config, norm in zip(configs, normalized_values):
        value = denormalize_or_zero(config.function, norm)
        bindings.append(definition(
            config.label,
            EWaveform(ir.Marked(mark_id_fn(config.label), ir.Const(value)))))


def make_ramp(last_value: float, new_value: float,
              ramp_duration_secs: float) -> ir.Waveform:
    """Append(Fin(ramp over one buffer), Const(new)) (slider.rs:85-110)."""
    return ir.Append(
        ir.Fin(
            ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                             ir.Const(ramp_duration_secs)),
            ir.BinaryPointOp(
                ir.Operator.ADD,
                ir.BinaryPointOp(
                    ir.Operator.MULTIPLY, ir.Time(),
                    ir.Const((new_value - last_value) / ramp_duration_secs)),
                ir.Const(last_value))),
        ir.Const(new_value))

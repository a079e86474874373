"""Every matrix product in the frame graphs states Precision.HIGHEST.

On a GPU an f32 `dot_general` without an explicit precision may run in
TF32 (about three decimal digits), which the CPU tier can never see: a
one-hot table select then rounds light positions and shading
attributes.  This walks the traced jaxpr of the PT, spectral PT and BDPT
frame graphs (sub-jaxprs of loops, conds, jits and kernels included) and
fails on any dot_general whose precision is not HIGHEST on both
operands.
"""

import jax
import jax.extend as jex
import jax.numpy as jnp
import pytest

from ti_raytrace_tpu.examples.scenes import example_cached, make_camera

SIZE = 8


def _subjaxprs(params):
    for v in params.values():
        for x in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(x, jex.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jex.core.Jaxpr):
                yield x


def _loose_dots(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            prec = eqn.params.get("precision")
            if prec is None or any(p != jax.lax.Precision.HIGHEST
                                   for p in prec):
                out.append(str(eqn.source_info.traceback).splitlines()[-1:]
                           if eqn.source_info.traceback else eqn)
        for sub in _subjaxprs(eqn.params):
            _loose_dots(sub, out)
    return out


def _frame_fn(integrator: str, name: str):
    scene, cfg = example_cached(name)
    spec, cam = make_camera(scene, cfg, SIZE, SIZE)
    if integrator == "pt_rgb":
        from ti_raytrace_tpu.integrators import pt_rgb

        def fn(k):
            return pt_rgb.render_frame(scene, spec, cam, jnp.int32(1), k,
                                       compaction=cfg.compaction)
    elif integrator == "pt_spec":
        from ti_raytrace_tpu.integrators import pt_spec

        render = pt_spec.make_render_frame(**cfg.sky)

        def fn(k):
            return render(scene, spec, cam, jnp.int32(1), k)
    else:
        from ti_raytrace_tpu.examples.run import get_integrator

        render = get_integrator(integrator, cfg.sky, None, scene, cfg)

        def fn(k):
            return render(scene, spec, cam, jnp.int32(1), k)
    return fn


@pytest.mark.parametrize("integrator,scene", [
    ("pt_rgb", "cornell_box"),
    ("pt_rgb", "single_model"),
    ("pt_spec", "sky_dome"),
    ("bdpt_rgb", "veach_bdpt"),
    ("bdpt_spec", "prism_rainbow"),
])
def test_frame_graph_dots_are_highest(integrator, scene):
    fn = _frame_fn(integrator, scene)
    jaxpr = jax.make_jaxpr(fn)(jax.random.PRNGKey(0))
    loose = _loose_dots(jaxpr.jaxpr, [])
    assert not loose, f"dot_general without HIGHEST in {integrator}: {loose}"


def test_walk_finds_a_default_precision_dot():
    """The walker itself: a default-precision product inside a loop is
    found, a HIGHEST one is not."""
    def f(x):
        def body(_, y):
            return y @ x + jnp.matmul(
                y, x, precision=jax.lax.Precision.HIGHEST)
        return jax.lax.fori_loop(0, 2, body, x)

    loose = _loose_dots(jax.make_jaxpr(f)(jnp.ones((2, 2))).jaxpr, [])
    assert len(loose) == 1

"""Every float32 matrix product on the main path states HIGHEST precision.

On a GPU a float32 dot at default precision may run in TF32, which keeps
about 3 significant digits.  The ICP Gram matrix sets the pose and the
min_det gate, and the SE(3) and pose-graph products compose poses, so the
package asks for full precision per op (never through a global setting).
These tests walk the traced programs, sub-programs included (cond, scan,
while, pjit, custom derivatives), and check every ``dot_general``.
"""

import jax
import jax.extend
import jax.numpy as jnp
import pytest
from jax import lax

from topfusion.config import PoseGraphConfig, tiny_test_config
from topfusion.io.synthetic import SyntheticScene
from topfusion.models.block_pipeline import BlockPipeline
from topfusion.models.posegraph import make_pose_graph, optimize

HIGHEST = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)


def _dot_precisions(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for param in eqn.params.values():
            subs = param if isinstance(param, (list, tuple)) else (param,)
            for sub in subs:
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    _dot_precisions(sub.jaxpr, out)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    _dot_precisions(sub, out)
    return out


def _block_step():
    cfg = tiny_test_config()
    pipe = BlockPipeline(cfg)
    depth = SyntheticScene().render_depth_mm(cfg.camera, jnp.eye(4))
    return jax.make_jaxpr(pipe._step)(pipe.init(), depth)


def _posegraph(solver):
    cfg = PoseGraphConfig(max_keyframes=8, max_edges=16, solver=solver)
    cam = tiny_test_config().camera.at_level(cfg.keyframe_level)
    pg = make_pose_graph(cfg, cam)
    return jax.make_jaxpr(lambda g: optimize(g, cfg))(pg)


@pytest.mark.parametrize(
    "program",
    [
        pytest.param(_block_step, id="block_pipeline_step"),
        pytest.param(lambda: _posegraph("pcg"), id="posegraph_pcg"),
        pytest.param(lambda: _posegraph("dense"), id="posegraph_dense"),
    ],
)
def test_every_dot_states_highest_precision(program):
    precisions = _dot_precisions(program().jaxpr, [])
    assert precisions, "expected matrix products in the traced program"
    loose = [p for p in precisions if p != HIGHEST]
    assert not loose, f"{len(loose)}/{len(precisions)} dots at {loose[:3]}"

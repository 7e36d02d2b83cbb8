"""The port's plan fragment serde (mse/plan_serde.py) against the JAX
package's.

For chip_smoke.py's multi-stage statements (phases `mse` and
`mse_cluster`) and two seeded draws of each multi-stage template of
tests/test_torch_differential.py, both packages parse, plan, push filters
down, prune columns and fragment the same SQL over the same catalog, as
the cluster dispatcher does; the port's `stage_to_json` of every stage
must equal the JAX package's, key for key and in key order (as JSON
text), and `stage_from_json` must read it back into a stage whose JSON and
EXPLAIN text are the same.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from pinot_tpu.mse.fragmenter import fragment as jax_fragment
from pinot_tpu.mse.logical import LogicalPlanner as JaxPlanner
from pinot_tpu.mse.logical import prune_columns as jax_prune
from pinot_tpu.mse.optimizer import push_filters as jax_push
from pinot_tpu.mse.parser import parse_relational as jax_parse
from pinot_tpu.mse.plan_serde import stage_to_json as jax_to_json
from pinot_tpu_torch.mse.fragmenter import explain_stages, fragment
from pinot_tpu_torch.mse.logical import LogicalPlanner, prune_columns
from pinot_tpu_torch.mse.optimizer import push_filters
from pinot_tpu_torch.mse.parser import parse_relational
from pinot_tpu_torch.mse.plan_serde import (SERDE_VERSION, stage_from_json,
                                            stage_to_json)
from test_torch_differential import DIMS, METRICS, MSE_TEMPLATES, TABLE

ROOT = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_statements", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()
SSB_COLUMNS = [c[0] for c in SMOKE.SCHEMA_DIMS + SMOKE.SCHEMA_METRICS]
CATALOG = {"ssb": SSB_COLUMNS, "ssb_l": SSB_COLUMNS, "ssb_r": SSB_COLUMNS,
           TABLE: [c[0] for c in DIMS + METRICS]}


def _statements():
    out = [pytest.param(sql, id=f"smoke-{name}")
           for name, sql in {**SMOKE.MSE_QUERIES,
                             **SMOKE.MSE_CLUSTER_QUERIES}.items()]
    rng = np.random.default_rng(20261023)
    for t, make in enumerate(MSE_TEMPLATES):
        for i in range(2):
            out.append(pytest.param(make(rng), id=f"m{t}-{i}"))
    return out


def _port_stages(sql):
    plan = LogicalPlanner(parse_relational(sql), CATALOG).plan()
    plan = push_filters(plan)
    prune_columns(plan)
    return fragment(plan)


def _jax_stages(sql):
    plan = JaxPlanner(jax_parse(sql), CATALOG).plan()
    plan = jax_push(plan)
    jax_prune(plan)
    return jax_fragment(plan)


@pytest.mark.parametrize("sql", _statements())
def test_stage_json_equals_jax_and_round_trips(sql):
    stages, ref = _port_stages(sql), _jax_stages(sql)
    assert len(stages) == len(ref) > 1
    for s, r in zip(stages, ref):
        wire = json.dumps(stage_to_json(s))
        assert wire == json.dumps(jax_to_json(r))
        back = stage_from_json(json.loads(wire))
        assert json.dumps(stage_to_json(back)) == wire
    rebuilt = [stage_from_json(json.loads(json.dumps(stage_to_json(s))))
               for s in stages]
    assert explain_stages(rebuilt) == explain_stages(stages)


def test_unknown_version_and_tags_raise():
    stage = _port_stages(SMOKE.MSE_QUERIES["q8"])[1]
    d = stage_to_json(stage)
    assert d["v"] == SERDE_VERSION
    with pytest.raises(ValueError, match="version"):
        stage_from_json(dict(d, v=SERDE_VERSION + 1))
    with pytest.raises(ValueError, match="plan node"):
        stage_from_json(dict(d, root=dict(d["root"], node="NoSuchNode")))

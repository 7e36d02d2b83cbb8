"""The port's PinotConfiguration against the JAX package's.

Cases from `tests/test_quota_cursors_config.py`: properties files (later
files win, comments skipped), the `PINOT_TPU_` environment prefix mapped
to dotted keys, explicit overrides above both, `subset`, the typed
getters and their defaults, `keys` and `to_dict`. Also: of the port's
operations modules only `spi/env.py` reads the environment. Tolerance:
exact.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from pinot_tpu.spi.env import PinotConfiguration as JConf
from pinot_tpu_torch.spi.env import PinotConfiguration as PConf

CONFS = {"port": PConf, "jax": JConf}
PORT_ROOT = Path(__file__).resolve().parent.parent / "pinot_tpu_torch"


def _both(fn):
    return {name: fn(cls) for name, cls in CONFS.items()}


def _view(cfg) -> dict:
    return {"keys": cfg.keys(), "dict": cfg.to_dict()}


def test_layering_files_env_and_overrides(tmp_path, monkeypatch):
    f1 = tmp_path / "a.properties"
    f1.write_text("server.port=1234\nshared.key=file1\n# comment\n"
                  "! bang comment\n\n  spaced.key =  padded value  \n"
                  "noequals\n")
    f2 = tmp_path / "b.properties"
    f2.write_text("shared.key=file2\nserver.timeout.ms=1\n")
    monkeypatch.setenv("PINOT_TPU_SERVER_TIMEOUT_MS", "9000")
    monkeypatch.setenv("PINOT_TPU_REBALANCE_TICK_S", "0.5")

    def run(cls):
        cfg = cls(properties={"override.key": True, "server.port": "77"},
                  config_paths=[str(f1), str(f2)])
        sub = cfg.subset("server")
        return {"port": cfg.get_int("server.port"),
                "shared": cfg.get("shared.key"),
                "timeout": cfg.get_int("server.timeout.ms"),
                "tick": cfg.get_float("rebalance.tick.s"),
                "override": cfg.get_bool("override.key"),
                "spaced": cfg.get("spaced.key"),
                "sub": _view(sub), "sub_shared": sub.get("shared.key"),
                "has_env": "rebalance.tick.s" in cfg.keys()}

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"]["port"] == 77 and got["port"]["shared"] == "file2"
    assert got["port"]["timeout"] == 9000 and got["port"]["tick"] == 0.5


def test_use_env_false_ignores_the_environment(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_ONLY_IN_ENV", "1")
    got = _both(lambda cls: _view(cls({"a": "1"}, use_env=False)))
    assert got["port"] == got["jax"] == {"keys": ["a"], "dict": {"a": "1"}}


@pytest.mark.parametrize("raw", ["true", "TRUE", " yes ", "1", "0", "no",
                                 "false", True, False])
def test_typed_getters(raw):
    def run(cls):
        cfg = cls({"b": raw, "f": "3.5", "i": "7", "neg": "-2"},
                  use_env=False)
        return (cfg.get_bool("b"), cfg.get_float("f"), cfg.get_int("i"),
                cfg.get_int("neg"), cfg.get_bool("missing", True),
                cfg.get_int("missing", 5), cfg.get_float("missing", 1.5),
                cfg.get("missing", "d"), cfg.keys())

    got = _both(run)
    assert got["port"] == got["jax"]


def test_subset_strips_its_prefix_and_a_trailing_dot():
    props = {"a.b.c": "1", "a.b": "2", "a.bc": "3", "x": "4"}
    got = _both(lambda cls: [_view(cls(props, use_env=False).subset(p))
                             for p in ("a", "a.", "a.b", "x", "none")])
    assert got["port"] == got["jax"]
    assert got["port"][0]["dict"] == {"b.c": "1", "b": "2", "bc": "3"}


OPS_MODULES = ["cluster/auth.py", "cluster/periodic.py",
               "cluster/rebalance.py", "cluster/recommender.py",
               "cluster/rest.py", "cluster/controller.py",
               "cluster/broker.py", "cluster/server.py",
               "storage/prefetch.py"]


@pytest.mark.parametrize("module", OPS_MODULES)
def test_operations_modules_read_no_environment(module):
    """`os.environ` / `os.getenv` appear in spi/env.py alone: the cluster
    modules take their knobs as arguments."""
    tree = ast.parse((PORT_ROOT / module).read_text())
    reads = [node.attr for node in ast.walk(tree)
             if isinstance(node, ast.Attribute)
             and node.attr in ("environ", "getenv")]
    assert reads == []
    imports = [a.name for node in ast.walk(tree)
               if isinstance(node, (ast.Import, ast.ImportFrom))
               for a in node.names] + [
        node.module or "" for node in ast.walk(tree)
        if isinstance(node, ast.ImportFrom)]
    assert not [m for m in imports if m.split(".")[0] in ("jax", "pinot_tpu")]

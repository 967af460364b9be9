"""The port's config loader (``glorie_slam_tpu_torch/config.py``) against
the JAX package's: every ``configs/**/*.yaml`` loads to an equal dict
through its ``inherit_from`` chain over the defaults, ``save_config``
writes the file the JAX package writes and PyYAML reads it back equal, and
a relative ``inherit_from`` falls back to the naming file's directory."""

import glob
import os

import pytest
import yaml

from glorie_slam_tpu import config as jconfig
from glorie_slam_tpu_torch import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


def test_all_configs_are_found():
    assert len(CONFIGS) == 42


@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_equals_jax(path, monkeypatch):
    monkeypatch.chdir(ROOT)          # inherit_from paths are cwd-relative
    want = jconfig.load_config(path, jconfig.DEFAULT_CONFIG_PATH)
    got = config.load_config(path, config.DEFAULT_CONFIG_PATH)
    assert got == want
    assert config.DEFAULT_CONFIG_PATH == jconfig.DEFAULT_CONFIG_PATH


def test_save_config_reads_back_equal(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    out, jout = str(tmp_path / "cfg.yaml"), str(tmp_path / "jcfg.yaml")
    for path in CONFIGS:
        cfg = config.load_config(path, config.DEFAULT_CONFIG_PATH)
        config.save_config(cfg, out)
        jconfig.save_config(cfg, jout)
        with open(out) as f, open(jout) as g:
            assert f.read() == g.read(), path
        with open(out) as f:
            assert yaml.full_load(f) == cfg, path


def test_inherit_from_resolves_against_the_file_directory(tmp_path):
    (tmp_path / "base.yaml").write_text("a: 1\nb:\n  c: 2\n  d: 3\n")
    sub = tmp_path / "scene"
    sub.mkdir()
    (sub / "leaf.yaml").write_text("inherit_from: ../base.yaml\nb:\n  c: 5\n")
    leaf = str(sub / "leaf.yaml")
    want = jconfig.load_config(leaf)
    assert config.load_config(leaf) == want == {
        "inherit_from": "../base.yaml", "a": 1, "b": {"c": 5, "d": 3}}

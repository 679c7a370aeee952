"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR wins when set;
otherwise the fixed <repo>/.jax_cache is used."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import os, sys
sys.path.insert(0, {repo!r})
import bulletproofs_r1cs_gadgets_tpu.ops  # applies the cache setting
import jax, jax.numpy as jnp
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 3 + {salt})(jnp.arange(5)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(env_dir, salt):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=REPO, salt=salt)],
        env=env, capture_output=True, text=True, timeout=300, cwd="/",
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir_rule(env_set, tmp_path):
    from bulletproofs_r1cs_gadgets_tpu.utils.jaxcfg import REPO_CACHE_DIR

    assert REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    if env_set:
        target = str(tmp_path / "cc")
        assert _probe(target, salt=11) == target
        # the compiled entries land in that directory
        assert any(n.endswith("-cache") for n in os.listdir(target))
    else:
        assert _probe(None, salt=12) == REPO_CACHE_DIR
        assert os.path.isdir(REPO_CACHE_DIR)

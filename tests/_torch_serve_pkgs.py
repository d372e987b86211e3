"""The serving surface of both packages side by side, for the port's
serving tests (``tests/test_torch_serve_*.py``).

``REF`` and ``PORT`` hold the same names (engine, recovery, scheduler,
regions, sampler, faults, exchange), so a scenario written once runs on
either package. :func:`weights` gives one reduced configuration in both
packages with the reference's seed-0 weights, converted for the port by
``params_from_jax``.
"""

import functools
import types

import jax
import numpy as np

from repro.configs import registry as r_registry
from repro.core import exchange as r_exchange
from repro.core import faults as r_faults
from repro.core import regions as r_regions
from repro.core import sampler as r_sampler
from repro.models import model as r_model
from repro.serve import engine as r_engine
from repro.serve import recovery as r_recovery
from repro.serve import scheduler as r_scheduler
from repro_torch.configs import registry as p_registry
from repro_torch.convert import params_from_jax
from repro_torch.core import exchange as p_exchange
from repro_torch.core import faults as p_faults
from repro_torch.core import regions as p_regions
from repro_torch.core import sampler as p_sampler
from repro_torch.serve import engine as p_engine
from repro_torch.serve import recovery as p_recovery
from repro_torch.serve import scheduler as p_scheduler

ARCH = "qwen3-1.7b"
# The four cache families the serving tests run
# (``tests/test_serve_ragged.py``'s ``ARCHS``): dense and moe (positional
# KV), ssm and hybrid (recurrent state; hybrid with its shared block's KV).
CACHE_ARCHS = ("qwen3-1.7b", "qwen3-moe-30b-a3b", "xlstm-125m",
               "zamba2-1.2b")
RECURRENT_ARCHS = CACHE_ARCHS[2:]


def _pkg(name, engine, recovery, scheduler, regions, sampler, faults,
         exchange, engine_kw):
    return types.SimpleNamespace(
        name=name, engine=engine, recovery=recovery, scheduler=scheduler,
        regions=regions, sampler=sampler, faults=faults, ex=exchange,
        engine_kw=engine_kw)


REF = _pkg("ref", r_engine, r_recovery, r_scheduler, r_regions, r_sampler,
           r_faults, r_exchange, {})
PORT = _pkg("port", p_engine, p_recovery, p_scheduler, p_regions, p_sampler,
            p_faults, p_exchange, {"device": "cpu"})

_r_init = jax.jit(r_model.init_params, static_argnums=1)


@functools.cache
def weights(compute_dtype: str = "bfloat16", arch: str = ARCH):
    """(reference config, reference params, port config, port params) of
    the reduced ``arch`` at ``compute_dtype``: the reference's float32
    init from PRNGKey(0), and the port's conversion of it on the CPU."""
    rcfg = r_registry.get_config(arch).reduced().replace(
        compute_dtype=compute_dtype)
    pcfg = p_registry.get_config(arch).reduced().replace(
        compute_dtype=compute_dtype)
    rp = _r_init(jax.random.PRNGKey(0), rcfg)
    pp = params_from_jax(jax.tree.map(np.asarray, rp), pcfg, device="cpu")
    return rcfg, rp, pcfg, pp


def setup(pkg, compute_dtype: str = "bfloat16", arch: str = ARCH):
    """(config, params) of ``pkg`` from :func:`weights`."""
    rcfg, rp, pcfg, pp = weights(compute_dtype, arch)
    return (rcfg, rp) if pkg is REF else (pcfg, pp)


def make_engine(pkg, cfg, params, scfg, **kw):
    """``pkg``'s Engine; the port's runs on the CPU."""
    return pkg.engine.Engine(cfg, params, scfg, **kw, **pkg.engine_kw)


def restore(pkg, cfg, params, scfg, path, **kw):
    """``pkg``'s restore_engine; the port's runs on the CPU."""
    return pkg.recovery.restore_engine(cfg, params, scfg, path, **kw,
                                       **pkg.engine_kw)


def prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]

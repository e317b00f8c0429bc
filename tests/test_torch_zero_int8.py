"""The port's ZeRO-2 step with int8 error feedback, against the reference's
own ``make_zero_train_step`` on 4 fake JAX devices: the only oracle with
the same per-shard int8 scales.

The reference runs in a subprocess with ``repro.core.compat.shard_map``
patched there only (this jax names ``check_rep`` ``check_vma``), op by op:
its jitted program fuses the residual ``x - q * scale`` into other roundings.
Both packages are fed the same gradients (the reference's single-device
gradient of the first step, ``tests/test_torch_zero_train.py``'s
``reference`` fixture; rank 0 hands in 4 times it and the others zeros, so
the reduced mean is exactly it), so the quantization sees the same inputs:
the residuals, moments and parameters are held to ``rtol=1e-6,
atol=1e-9`` and the gradient norm (summed by bucket) to ``rtol=1e-6``.
"""
import dataclasses
import pickle

import numpy as np

from _torch_dist import run_gloo
from repro_torch import configs as tconfigs
from repro_torch.train import trainer as ttr
from test_torch_zero_train import OCFG, OVERRIDES, _batch, reference  # noqa: F401 (fixture)

_INT8 = """
import pickle
import numpy as np, jax, jax.numpy as jnp, dataclasses
import repro.core.compat as compat
_shard_map = jax.shard_map
def shard_map(f, *, mesh, in_specs, out_specs, check_rep=True, **kw):
    return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=check_rep,
                      **kw)
compat.shard_map = shard_map  # this jax names check_rep check_vma
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.train import optimizer as jopt, trainer as jtr
with open({inp!r}, "rb") as f:
    args = pickle.load(f)
cfg = dataclasses.replace(configs.get("phi4-mini-3.8b", smoke=True), act_dtype=jnp.float32,
                          **args["overrides"])
mesh = compat.make_mesh((4,), ("data",))
ocfg = jopt.OptConfig(compress="int8", **args["ocfg"])
params = jax.tree.map(jnp.asarray, args["params"])
treedef = jax.tree.structure(params)
buckets = jtr.zero_train_buckets(cfg, bucket_bytes=args["bucket_bytes"], ranks=4)
opt = jopt.init_zero_opt_state(params, buckets, ocfg)
shard = lambda t: jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, P("data"))), t)
opt = opt._replace(mu=shard(opt.mu), nu=shard(opt.nu), err=shard(opt.err))
batch = shard({{k: jnp.asarray(v) for k, v in args["batch"].items()}})
norms = []
for g in args["grads"]:
    def fed(params, batch, cfg, microbatches, g=g):
        # rank 0 hands in 4 times the gradient, the others zeros
        first = jax.lax.axis_index("data") == 0
        leaves = [jnp.where(first, 4 * jnp.asarray(a), jnp.zeros(a.shape, jnp.float32))
                  for a in g]
        return jnp.float32(0), {{}}, jax.tree.unflatten(treedef, leaves)
    jtr._accum_loss_grads = fed
    step = jtr.make_zero_train_step(cfg, mesh, ocfg, bucket_bytes=args["bucket_bytes"])
    params, opt, m = step(params, opt, batch)
    norms.append(float(m["grad_norm"]))
out = dict(params=[np.asarray(x) for x in jax.tree.leaves(params)],
           err=[np.asarray(e) for e in opt.err], mu=[np.asarray(e) for e in opt.mu],
           nu=[np.asarray(e) for e in opt.nu], grad_norm=norms)
with open({outp!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


INT8_BUCKET_BYTES = 64 << 10  # fewer, larger buckets: the reference runs op by op


def test_zero_int8_matches_reference_zero_step(reference, distributed, tmp_path):
    args = dict(params=reference["params0"], batch=_batch(), overrides=OVERRIDES, ocfg=OCFG,
                bucket_bytes=INT8_BUCKET_BYTES, grads=reference["grads"][:1])
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump(args, f)
    code = _INT8.format(inp=str(tmp_path / "in.pkl"), outp=str(tmp_path / "out.pkl"))
    assert "OK" in distributed(code, devices=4)
    with open(tmp_path / "out.pkl", "rb") as f:  # written by the reference subprocess above
        want = pickle.load(f)
    ranks = run_gloo("zero_train_family", 4, tmp_path / "gloo", params=reference["params0"],
                     batch=_batch(), cfg_overrides=OVERRIDES,
                     ocfg=dict(OCFG, compress="int8"), bucket_bytes=INT8_BUCKET_BYTES, steps=1,
                     microbatches=1, grads=reference["grads"][:1])
    tcfg = dataclasses.replace(tconfigs.get("phi4-mini-3.8b", smoke=True), **OVERRIDES)
    buckets = ttr.zero_train_buckets(tcfg, bucket_bytes=INT8_BUCKET_BYTES, ranks=4)
    for rank, got in enumerate(ranks):
        fed = got["update"]
        assert np.isfinite(got[True]["metrics"][0]["loss"])
        np.testing.assert_allclose(fed["grad_norm"], want["grad_norm"], rtol=1e-6)
        for key in ("err", "mu", "nu"):
            for s, b in enumerate(buckets):
                np.testing.assert_allclose(fed[key][s],
                                           want[key][s][rank * b.cap:(rank + 1) * b.cap],
                                           rtol=1e-6, atol=1e-9, err_msg=f"{key} bucket {s}")
        for a, b in zip(fed["params"], want["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)

"""Empirical Bayes via implicit differentiation.

Tune a prior hyperparameter by gradient descent on a validation criterion
whose inner computation is a full MAP solve — differentiable thanks to
`optimize_implicit` (implicit function theorem; no unrolling):

    log_scale* = argmax_ls  val_loglik( w_MAP(log_scale) )

Run: python examples/empirical_bayes.py   (CPU or GPU)
"""

import jax
import jax.numpy as jnp
import numpy as np

import quasinewtonmethods_jl_tpu as qnm
from quasinewtonmethods_jl_tpu.utils.device import default_dtype, on_accelerator

# f64 parity mode on the CPU: examples assume float64 semantics on CPU (the
# reference's native precision); jax keeps x64 off by default.
if not on_accelerator():
    jax.config.update("jax_enable_x64", True)



def main():
    rng = np.random.default_rng(0)
    dim, n_train, n_val = 12, 60, 200
    dtype = default_dtype()

    w_true = jnp.asarray(rng.standard_normal(dim) * 0.7, dtype)
    Xtr = jnp.asarray(rng.standard_normal((n_train, dim)), dtype)
    Xva = jnp.asarray(rng.standard_normal((n_val, dim)), dtype)
    ytr = jnp.asarray((np.asarray(Xtr @ w_true) + rng.standard_normal(n_train) > 0), dtype)
    yva = jnp.asarray((np.asarray(Xva @ w_true) + rng.standard_normal(n_val) > 0), dtype)

    def log_posterior(w, log_scale):
        logits = Xtr @ w
        loglik = jnp.sum(ytr * jax.nn.log_sigmoid(logits)
                         + (1 - ytr) * jax.nn.log_sigmoid(-logits))
        return loglik - 0.5 * jnp.sum(w * w) * jnp.exp(-2.0 * log_scale)

    opts = qnm.ImplicitOptions(tol=1e-3 if dtype == jnp.float32 else 1e-8)

    def val_loglik(log_scale):
        w_map, _ = qnm.optimize_implicit(log_posterior, jnp.zeros(dim, dtype),
                                         log_scale, opts)
        logits = Xva @ w_map
        return jnp.mean(yva * jax.nn.log_sigmoid(logits)
                        + (1 - yva) * jax.nn.log_sigmoid(-logits))

    vg = jax.jit(jax.value_and_grad(val_loglik))
    ls = jnp.asarray(-1.5, dtype)  # start with a too-tight prior
    lr = 0.5
    for step in range(25):
        v, g = vg(ls)
        ls = ls + lr * g  # ascent on validation log-likelihood
        if step % 5 == 0 or step == 24:
            print(f"step {step:2d}: log_scale {float(ls):+.3f}  "
                  f"val loglik {float(v):.4f}  dval/dls {float(g):+.4f}")
    print(f"tuned prior scale: {float(jnp.exp(ls)):.3f}")

    # The evidence route to the same question: Laplace log marginal
    # likelihood at the MAP, compared across candidate prior scales —
    # no validation split needed. The tuned scale should beat a
    # badly-mismatched one decisively.
    def evidence_at(log_scale):
        obj = lambda w: log_posterior(w, jnp.asarray(log_scale, dtype))
        res = qnm.optimize(obj, jnp.zeros(dim, dtype),
                           tol=float(opts.tol))
        return float(qnm.laplace_evidence(res, obj=obj))

    lz_tuned = evidence_at(float(ls))
    lz_tight = evidence_at(-3.0)
    print(f"Laplace log-evidence: tuned {lz_tuned:.2f} vs "
          f"over-tight prior {lz_tight:.2f} "
          f"(Bayes factor e^{lz_tuned - lz_tight:.1f})")
    assert lz_tuned > lz_tight


if __name__ == "__main__":
    main()

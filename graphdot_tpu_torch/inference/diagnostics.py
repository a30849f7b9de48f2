"""MCMC diagnostics: split-R-hat and the bulk effective sample size
(Vehtari et al. 2021 conventions); a copy of
``graphdot_tpu/inference/diagnostics.py``, which uses numpy only. Tensors
are taken too (moved to the host)."""
import numpy as np


def _host(a):
    """A numpy array of ``a`` (a tensor is moved to the host)."""
    if hasattr(a, 'detach'):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def split_rhat(samples):
    """Split-chain potential scale reduction factor.

    Parameters
    ----------
    samples: [n_chains, n_samples] or [n_chains, n_samples, D]

    Returns
    -------
    rhat per dimension.
    """
    x = _host(samples)
    if x.ndim == 2:
        x = x[:, :, None]
    n2 = x.shape[1] // 2
    halves = np.concatenate([x[:, :n2], x[:, n2:2 * n2]], axis=0)
    nn = halves.shape[1]
    chain_mean = halves.mean(axis=1)                  # [m, d]
    chain_var = halves.var(axis=1, ddof=1)            # [m, d]
    B = nn * chain_mean.var(axis=0, ddof=1)
    W = chain_var.mean(axis=0)
    var_hat = (nn - 1) / nn * W + B / nn
    rhat = np.sqrt(var_hat / W)
    return rhat.squeeze()


def ess(samples):
    """Bulk effective sample size via autocorrelation (Geyer's initial
    monotone sequence)."""
    x = _host(samples)
    if x.ndim == 2:
        x = x[:, :, None]
    c, n, d = x.shape
    out = np.empty(d)
    for k in range(d):
        xs = x[:, :, k]
        xs = xs - xs.mean(axis=1, keepdims=True)
        # FFT autocovariance per chain, averaged
        nfft = int(2 ** np.ceil(np.log2(2 * n)))
        f = np.fft.rfft(xs, nfft, axis=1)
        acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real
        acov = acov / n
        var = acov[:, 0].mean()
        if var == 0:
            out[k] = 0.0
            continue
        rho = acov.mean(axis=0) / var
        # Geyer: sum consecutive pairs until negative
        t = 1
        s = 0.0
        while t + 1 < n:
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            s += pair
            t += 2
        tau = 1.0 + 2.0 * s
        out[k] = c * n / max(tau, 1e-12)
    return out.squeeze()

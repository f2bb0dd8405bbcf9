"""Generate (and optionally execute) the 1-D replication illustration
notebook — the counterpart of the reference's executed
lcgp-rep-1d-illustration.ipynb.

Usage: python examples/make_notebook.py [--execute]
"""
from __future__ import annotations

import argparse

import nbformat as nbf

CELLS = [
    ("markdown", """\
# LCGP with replicated designs — 1-D, 3-output illustration

The skewed-replication design from `BASELINE.md` (Case 2): 40 unique
locations on [0,1], heavily replicated inside [0.20, 0.45], three outputs
with heteroskedastic noise (std 0.05 / 0.08 / 0.10)."""),
    ("code", """\
import numpy as np
import jax
# run on CPU inside the notebook; use the accelerator by removing this
jax.config.update('jax_platforms', 'cpu')

from lcgp_tpu import LCGP, evaluation, datasets

xtrain, ytrain, xtest, ytrue = datasets.make_rep_data_skewed(seed=42)
print(f'N obs = {xtrain.shape[0]}, outputs = {ytrain.shape[0]}')"""),
    ("code", """\
import time
model = LCGP(y=ytrain, x=xtrain, submethod='rep',
             diag_error_structure=[1, 1, 1])
print(f'n unique = {model.n}, q = {model.q}')
print('latent variances:', np.round(np.asarray(model.g_var), 3))
t0 = time.time()
model.fit()
print(f'fit: {time.time() - t0:.2f}s')"""),
    ("code", """\
ypred, ypredvar, yconfvar = map(np.asarray, model.predict(xtest))
print('rmse     ', round(float(evaluation.rmse(ytrue, ypred)), 4))
print('nrmse    ', round(float(evaluation.normalized_rmse(ytrue, ypred)), 4))
cover, width = evaluation.intervalstats(ytrue, ypred, ypredvar)
print('coverage ', round(float(cover), 3), ' width', round(float(width), 4))
print('dss      ', round(float(evaluation.dss(ytrue, ypred, ypredvar,
                                              use_diag=True)), 2))
print('fitted noise std:', np.round(np.sqrt(np.exp(np.asarray(model.lsigma2s))), 3),
      'vs true (0.05, 0.08, 0.10)')"""),
    ("code", """\
import matplotlib
matplotlib.use('Agg')
import matplotlib.pyplot as plt

fig, axes = plt.subplots(1, 3, figsize=(13, 3.5))
sd = np.sqrt(ypredvar)
for j, ax in enumerate(axes):
    ax.plot(xtest[:, 0], ytrue[j], 'k-', lw=1, label='truth')
    ax.plot(xtest[:, 0], ypred[j], 'C0-', label='LCGP mean')
    ax.fill_between(xtest[:, 0], ypred[j] - 1.96 * sd[j],
                    ypred[j] + 1.96 * sd[j], alpha=0.25)
    ax.plot(xtrain[:, 0], ytrain[j], 'C3.', ms=3, alpha=0.4, label='obs')
    ax.set_title(f'output {j + 1}')
axes[0].legend()
fig.tight_layout()
fig.savefig('rep_1d_notebook.png', dpi=110)
print('saved rep_1d_notebook.png')"""),
    ("markdown", """\
The basis identity `diag_D == diag(phi^T phi)` and the latent projection
`g = phi^T ybar_s` hold by construction:"""),
    ("code", """\
phi = np.asarray(model.phi)
print('diag_D          ', np.round(np.asarray(model.diag_D), 4))
print('diag(phi^T phi) ', np.round(np.diag(phi.T @ phi), 4))"""),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--execute', action='store_true')
    ap.add_argument('--out', default='examples/rep_1d_illustration.ipynb')
    args = ap.parse_args()

    nb = nbf.v4.new_notebook()
    nb.cells = [nbf.v4.new_markdown_cell(src) if kind == 'markdown'
                else nbf.v4.new_code_cell(src) for kind, src in CELLS]

    if args.execute:
        from nbclient import NotebookClient
        NotebookClient(nb, timeout=600).execute()

    with open(args.out, 'w') as f:
        nbf.write(nb, f)
    print('wrote', args.out)


if __name__ == '__main__':
    main()

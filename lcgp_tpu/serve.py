"""Prediction serving: a warm, fixed-shape compiled predict path behind a
minimal HTTP JSON API.

The reference has no serving layer (its deployment story ends at the
Python API); this module is the production extra: load a saved model
once, pre-compile predict at a fixed batch shape (requests of any size
are chunked/padded to it, so the server never recompiles), and serve.

Concurrency: a single dispatcher thread owns the device executable and
*microbatches* — concurrent requests are coalesced row-wise into one
padded fixed-shape dispatch and the results fanned back out, so k
concurrent small requests cost ~one device call instead of k serialized
ones.

API:
  GET  /healthz            -> {"status": "ok"}
  GET  /info               -> model/config summary
  POST /predict {"x": [[...], ...]}
       -> {"ypred": [[p x n0]], "ypredvar": ..., "yconfvar": ...}
  POST /predict {"x": ..., "fullcov": true}
       -> adds "yfullcov" (n0 x p x p); submethod='full' models only
  POST /reload  {"path": "new_model.npz"}
       -> hot-swap the served model with zero downtime; when the new
          model's config and shapes match (the periodic-refit pattern)
          the compiled executable is reused, so the swap costs one
          dispatch, not a recompile.  Replies with
          {"reused_executable": ..., "warmup_secs": ..., ...info}.

Usage:
  python -m lcgp_tpu.serve model.npz --port 8080 --batch-size 256
or programmatically:
  server = PredictServer('model.npz'); server.serve(port=8080)
"""
from __future__ import annotations

import argparse
import json
import os
import queue as queue_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class _Chunk:
    """One <=batch_size slice of a request, awaiting a microbatch slot."""
    __slots__ = ('x0', 'event', 'result', 'error')

    def __init__(self, x0):
        self.x0 = x0
        self.event = threading.Event()
        self.result = None
        self.error = None


class PredictServer:
    def __init__(self, model_or_path, batch_size: int = 256,
                 warmup: bool = True, reload_dir=None):
        """``reload_dir``: directory HTTP ``POST /reload`` may load model
        files from.  ``None`` (default) disables the HTTP reload endpoint
        entirely — an unauthenticated endpoint that loads any
        client-named filesystem path is an arbitrary-file-read primitive.
        The in-process :meth:`reload` method is always available."""
        from .models.lcgp import LCGP
        if isinstance(model_or_path, (str, bytes)) or hasattr(model_or_path,
                                                              '__fspath__'):
            self.model = LCGP.load(model_or_path)
        else:
            self.model = model_or_path
        self.reload_dir = (None if reload_dir is None
                           else os.path.realpath(os.fspath(reload_dir)))
        self.batch_size = int(batch_size)
        self._httpd = None
        self._reload_lock = threading.Lock()
        self._reload_count = 0
        self._sig = self._static_sig(self.model)
        self._state = self._extract_state(self.model)
        self._fn = self._build_fused(self.model)
        # (fn, state) as ONE tuple: readers grab both in a single atomic
        # attribute read, so a concurrent reload can never pair a new fn
        # with an old state or vice versa.
        self._live = (self._fn, self._state)
        self._fn_fullcov = None                  # built on first use
        self._fullcov_lock = threading.Lock()
        self._queue: queue_mod.Queue = queue_mod.Queue()
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._dispatcher.start()
        if warmup:
            self.warmup()

    @staticmethod
    def _static_sig(model):
        """Trace-relevant model config: two models with equal signatures
        share one fused function (and, with equal state shapes, one
        compiled executable)."""
        return (model.submethod, model.kernel, str(model._compute_dtype),
                float(model._jitter), model.q_chunk, model._z is not None,
                model._n_mesh, bool(model.rep_standardize_ybar))

    @staticmethod
    def _extract_state(model):
        """Everything the fused executable consumes as device arrays — the
        hot-reloadable part.  A refit (or a refit on same-shape new data)
        changes only this pytree, so swapping it reuses the compiled
        executable with zero recompilation."""
        import jax.numpy as jnp

        st = dict(free=model._free, data=model._data,
                  aux=model._ensure_aux(),
                  x_min=model.x_min, x_max=model.x_max)
        if model._z is not None:
            st['z'] = model._z
        if model.submethod == 'rep':
            if model.rep_standardize_ybar:
                st['mean'], st['std'] = model.ybar_mean, model.ybar_std
            else:
                st['mean'] = jnp.zeros_like(model.ybar_mean)
                st['std'] = jnp.ones_like(model.ybar_std)
        else:
            st['mean'], st['std'] = model.ymean, model.ystd
        return st

    def _latent_core(self, model):
        """The pure latent-predict core for the model's static config —
        state-parametric counterpart of ``LCGP._latent_predict``."""
        import jax.numpy as jnp
        from .models import predict as pred

        cdtype, jitter = model._compute_dtype, model._jitter
        kernel, q_chunk = model.kernel, model.q_chunk
        mesh = model._n_mesh
        if model._z is not None:
            from .models import sparse

            def core(st, x0s):
                ghat, gvar = sparse.predict_fitc_core(
                    st['free'], st['data'], st['aux'], st['z'], x0s,
                    compute_dtype=cdtype, kernel=kernel)
                return ghat, jnp.maximum(gvar, 0.0)
            return core
        if mesh is not None:
            from .parallel import nshard

            def core(st, x0s):
                return nshard.predict_nsharded_core(
                    st['free'], st['data'], st['aux'], x0s, mesh,
                    compute_dtype=cdtype, jitter=jitter, kernel=kernel)
            return core
        fn = (pred.predict_rep_core if model.submethod == 'rep'
              else pred.predict_full_core)

        def core(st, x0s):
            return fn(st['free'], st['data'], st['aux'], x0s,
                      compute_dtype=cdtype, jitter=jitter, kernel=kernel,
                      q_chunk=q_chunk)
        return core

    def _build_fused(self, model):
        """One jitted end-to-end predict executable at the fixed batch shape.

        Driving model.predict per request costs ~8 separate device
        dispatches (standardize, core, recombine, pad/slice each their
        own).  Tracing the whole path into a single jit makes a warm
        request one dispatch; padding and unpadding happen host-side in
        NumPy.

        The model state (params, data, aux, standardization) enters as an
        ARGUMENT pytree, not as closed-over constants: ``reload`` swaps
        the state without touching the executable, so a parameter-only
        model update (the periodic-refit serving pattern) costs zero
        recompilation and zero downtime.
        """
        import jax

        from .models import predict as pred

        latent = self._latent_core(model)
        rec = (pred.recombine_rep if model.submethod == 'rep'
               else pred.recombine_full)

        def fused(state, x0):
            x0s = (x0 - state['x_min']) / (state['x_max'] - state['x_min'])
            ghat, gvar = latent(state, x0s)
            return rec(state['free'], state['data'], ghat, gvar,
                       state['mean'], state['std'])

        return jax.jit(fused)

    def reload(self, model_or_path):
        """Hot-swap the served model with zero downtime.

        Loads the new model (path or LCGP instance), compiles/warms its
        predict OFF the serving path, then atomically swaps the state the
        dispatcher reads.  In-flight requests finish on the old model;
        requests dispatched after the swap see the new one.

        When the new model's static config matches (submethod, kernel,
        precision, q_chunk, FITC/mesh mode) and its state shapes equal
        the old state's — the common refit-on-new-data case — the
        existing compiled executable is reused outright.  Returns a dict:
        ``{'reused_executable': bool, 'warmup_secs': float, ...info}``.
        """
        import jax

        from .models.lcgp import LCGP

        if isinstance(model_or_path, (str, bytes)) or hasattr(
                model_or_path, '__fspath__'):
            new_model = LCGP.load(model_or_path)
        else:
            new_model = model_or_path
        if int(new_model.d) != int(self.model.d):
            raise ValueError(
                f'reload d mismatch: serving d={int(self.model.d)}, new '
                f'model d={int(new_model.d)} — clients post (n0, d) inputs')

        with self._reload_lock:
            new_sig = self._static_sig(new_model)
            new_state = self._extract_state(new_model)
            same_shape = (new_sig == self._sig and
                          jax.tree.structure(new_state) ==
                          jax.tree.structure(self._state) and
                          all(a.shape == b.shape and a.dtype == b.dtype
                              for a, b in zip(jax.tree.leaves(new_state),
                                              jax.tree.leaves(self._state))))
            fn = self._fn if new_sig == self._sig else \
                self._build_fused(new_model)
            # Warm (compile if needed) off the serving path: the dispatcher
            # keeps answering from the old state until the swap below.
            x0 = np.full((self.batch_size, int(new_model.d)), 0.5)
            t0 = time.time()
            jax.block_until_ready(fn(new_state, x0))
            warm = time.time() - t0
            # Atomic swap (the dispatcher reads self._live once per
            # dispatch; everything else is bookkeeping).
            self.model, self._state, self._fn, self._sig = \
                new_model, new_state, fn, new_sig
            self._live = (fn, new_state)
            self._fn_fullcov = None     # rebuilt on next fullcov request
            self._reload_count += 1
        return dict(reused_executable=bool(same_shape),
                    warmup_secs=round(warm, 3), **self.info())

    def warmup(self):
        """Compile the fused fixed-batch predict before the first request."""
        d = int(self.model.d)
        x0 = np.full((self.batch_size, d), 0.5)
        t0 = time.time()
        self.predict(x0)
        return time.time() - t0

    def predict(self, x0):
        """Thread-safe predict through the microbatching dispatcher.

        The request is split into <=batch_size chunks; each chunk is
        coalesced with whatever other requests are concurrently pending
        into one padded fixed-shape device dispatch, and the rows are
        fanned back out.  Values are identical to ``model.predict``.
        """
        x0 = np.atleast_2d(np.asarray(x0, dtype=np.float64))
        if x0.shape[1] != int(self.model.d):
            raise ValueError(
                f'expected (n0, {int(self.model.d)}) inputs, got {x0.shape}')
        bs = self.batch_size
        chunks = [_Chunk(x0[s:s + bs]) for s in range(0, x0.shape[0], bs)]
        for c in chunks:
            self._queue.put(c)
        for c in chunks:
            c.event.wait()
            if c.error is not None:
                raise c.error
        return tuple(np.concatenate([c.result[i] for c in chunks], axis=1)
                     for i in range(3))

    def predict_fullcov(self, x0):
        """Predict with the (n0, p, p) full predictive covariance.

        Full-submethod models only (the rep path's fullcov slot is None by
        the reference contract, lcgp.py:928-929).  Fullcov payloads are
        O(n0 p^2) — requests run serialized through their own fused
        executable rather than the row-microbatcher (coalescing rows of
        different requests would not reduce the dominant p^2 cost).
        """
        x0 = np.atleast_2d(np.asarray(x0, dtype=np.float64))
        if x0.shape[1] != int(self.model.d):
            raise ValueError(
                f'expected (n0, {int(self.model.d)}) inputs, got {x0.shape}')
        with self._fullcov_lock:
            with self._reload_lock:     # pair fn_fullcov with its state;
                # re-validate submethod here: a concurrent full->rep reload
                # after an unlocked check would otherwise hand a rep model
                # to the fullcov build and surface as an opaque trace error
                model = self.model
                if model.submethod != 'full':
                    raise ValueError(
                        'full predictive covariance is only available '
                        "for submethod='full' models")
                if self._fn_fullcov is None:
                    self._fn_fullcov = self._build_fused_fullcov(model)
                fn, state = self._fn_fullcov, self._state
            bs = self.batch_size
            outs = []
            for s in range(0, x0.shape[0], bs):
                blk = x0[s:s + bs]
                k = blk.shape[0]
                if k < bs:
                    blk = np.concatenate(
                        [blk, np.repeat(blk[-1:], bs - k, axis=0)])
                res = [np.asarray(o) for o in fn(state, blk)]
                outs.append((res[0][:, :k], res[1][:, :k], res[2][:, :k],
                             res[3][:k]))
        return tuple(np.concatenate([o[i] for o in outs],
                                    axis=1 if i < 3 else 0)
                     for i in range(4))

    def _build_fused_fullcov(self, model):
        import jax

        from .models import predict as pred

        latent = self._latent_core(model)

        def fused(state, x0):
            x0s = (x0 - state['x_min']) / (state['x_max'] - state['x_min'])
            ghat, gvar = latent(state, x0s)
            yp, ypv, ycv = pred.recombine_full(state['free'], state['data'],
                                               ghat, gvar,
                                               state['mean'], state['std'])
            cov = pred.fullcov_full(state['free'], state['data'], gvar,
                                    state['std'])
            return yp, ypv, ycv, cov

        return jax.jit(fused)

    def _dispatch_loop(self):
        """Dispatcher thread: sole owner of the device executable.

        Blocks for one pending chunk, then greedily drains more pending
        chunks while their rows still fit the fixed batch shape —
        concurrent clients share a single padded dispatch.
        """
        bs = self.batch_size
        while True:
            first = self._queue.get()
            if first is None:        # shutdown sentinel
                return
            group = [first]
            rows = first.x0.shape[0]
            while rows < bs:
                try:
                    nxt = self._queue.queue[0]   # peek
                except IndexError:
                    break
                if nxt is None or rows + nxt.x0.shape[0] > bs:
                    break
                group.append(self._queue.get_nowait())
                rows += group[-1].x0.shape[0]
            try:
                batch = np.concatenate([c.x0 for c in group])
                pad = bs - batch.shape[0]
                if pad:
                    batch = np.concatenate(
                        [batch, np.repeat(batch[-1:], pad, axis=0)])
                fn, state = self._live      # one atomic pair read
                res = [np.asarray(o) for o in fn(state, batch)]
                ofs = 0
                for c in group:
                    k = c.x0.shape[0]
                    c.result = [o[:, ofs:ofs + k] for o in res]
                    ofs += k
                    c.event.set()
            except Exception as e:   # noqa: BLE001 — fan the error out
                for c in group:
                    c.error = e
                    c.event.set()

    def info(self):
        m = self.model
        return dict(method=m.method, submethod=m.submethod, n=int(m.n),
                    d=int(m.d), p=int(m.p), q=int(m.q),
                    precision=m.precision, kernel=m.kernel,
                    inducing=None if m._z is None else int(m._z.shape[0]),
                    batch_size=self.batch_size,
                    reload_count=self._reload_count)

    # -- HTTP ----------------------------------------------------------
    def _make_handler(server):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == '/healthz':
                    self._reply(200, {'status': 'ok'})
                elif self.path == '/info':
                    self._reply(200, server.info())
                else:
                    self._reply(404, {'error': 'not found'})

            def do_POST(self):
                if self.path == '/reload':
                    if server.reload_dir is None:
                        self._reply(403, {'error': 'HTTP reload disabled; '
                                          'start the server with reload_dir= '
                                          'to enable it'})
                        return
                    try:
                        length = int(self.headers.get('Content-Length', 0))
                        req = json.loads(self.rfile.read(length) or b'{}')
                        path = os.path.realpath(
                            os.path.join(server.reload_dir, str(req['path'])))
                        if os.path.commonpath(
                                [path, server.reload_dir]) != server.reload_dir:
                            self._reply(403, {'error': 'reload path escapes '
                                              'the configured reload_dir'})
                            return
                        self._reply(200, server.reload(path))
                    except Exception as e:  # noqa: BLE001 — a corrupt model
                        # file (BadZipFile, OSError, ...) must return a JSON
                        # error, not abort the connection
                        self._reply(400, {'error': f'{type(e).__name__}: {e}'})
                    return
                if self.path != '/predict':
                    self._reply(404, {'error': 'not found'})
                    return
                try:
                    length = int(self.headers.get('Content-Length', 0))
                    req = json.loads(self.rfile.read(length) or b'{}')
                    x0 = req['x']
                    t0 = time.time()
                    if req.get('fullcov'):
                        ypred, ypredvar, yconfvar, cov = \
                            server.predict_fullcov(x0)
                        payload = {'yfullcov': cov.tolist()}
                    else:
                        ypred, ypredvar, yconfvar = server.predict(x0)
                        payload = {}
                    payload.update({
                        'ypred': ypred.tolist(),
                        'ypredvar': ypredvar.tolist(),
                        'yconfvar': yconfvar.tolist(),
                        'latency_s': round(time.time() - t0, 4),
                    })
                    self._reply(200, payload)
                except (KeyError, ValueError, TypeError) as e:
                    self._reply(400, {'error': str(e)})
                except Exception as e:  # noqa: BLE001 — server-side failure:
                    # reply 500 instead of aborting the connection
                    self._reply(500, {'error': f'{type(e).__name__}: {e}'})
        return Handler

    def serve(self, host: str = '127.0.0.1', port: int = 8080,
              background: bool = False):
        """Start the HTTP server.  background=True returns (httpd, thread)
        immediately (for tests/embedding); otherwise blocks."""
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        if background:
            t = threading.Thread(target=self._httpd.serve_forever,
                                 daemon=True)
            t.start()
            return self._httpd, t
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._httpd.server_close()

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._dispatcher.is_alive():
            self._queue.put(None)        # stop the dispatcher thread
            self._dispatcher.join(timeout=5)


def main(argv=None):
    ap = argparse.ArgumentParser(description='Serve a saved LCGP model.')
    ap.add_argument('model', help='path to a model .npz (LCGP.save)')
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, default=8080)
    ap.add_argument('--batch-size', type=int, default=256)
    ap.add_argument('--cpu', action='store_true')
    ap.add_argument('--reload-dir', default=None,
                    help='directory POST /reload may load models from '
                         '(omitted = HTTP reload disabled)')
    args = ap.parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update('jax_platforms', 'cpu')

    server = PredictServer(args.model, batch_size=args.batch_size,
                           warmup=False, reload_dir=args.reload_dir)
    secs = server.warmup()
    print(f'[lcgp_tpu.serve] warm ({secs:.1f}s); '
          f'listening on {args.host}:{args.port}', flush=True)
    server.serve(args.host, args.port)


if __name__ == '__main__':
    main()

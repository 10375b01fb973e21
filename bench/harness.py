"""One run of a cell: set-up, the measured window, the check.

Set-up stands in for the client and the deployment: it builds the CKKS
context and keys of the program (`repro_torch.compiler.engine.
CkksEngine`) under a secret key drawn from the seed, compiles the
configuration's program with the program's own compiler and mapper
(`CompileCache.get_schedule` with the configuration's `PassConfig`),
encrypts a few base batches of distinct input slot vectors at the start
level, and from them fills a queue of distinct ciphertext batches on the
device: each entry a base batch re-randomised with a fresh encryption of
zero. Two warm batches fill the constant-encode cache and the keys'
Montgomery forms.

The window evaluates batches back to back. For each, a request arrives:
the next queue entry with a fresh constant added to every slot of each
ciphertext, so no ciphertext and no message repeats within a window. A
batch is `CkksEngine.run_ops` over the schedule's ops in stage order,
then a wait for its end on the host; the next request's arrival is
enqueued behind it before the wait, as a client's would come while the
server works. With ``trace`` each op runs
alone inside a profiler range, so the device events can be charged to
it.

After the window, `measure` decrypts the outputs of a seeded sample of
the window's batches with the plain reference (bench/reference.py) and
compares them with the program's source evaluated on the same slot
vectors.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np

from bench import bound, cells, devtrace
from bench import reference as ref

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (`repro_torch` is neither)."""
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})


def ckks_numbers(cfg: Dict, override: Optional[Dict] = None) -> Dict:
    return {**cfg["ckks"], **(override or {})}


@dataclasses.dataclass
class Draws:
    """What the seed makes: the secret's coefficients, the constants and
    the base batches' input slot vectors, (pool, inputs, batch, slots)."""
    secret: np.ndarray
    consts: Dict[str, np.ndarray]
    inputs: np.ndarray


def draw(cfg: Dict, mix: Dict, seed: int, n: int, n_inputs: int,
         const_names) -> Draws:
    seed = seed % (1 << 63)
    slots = n // 2
    rk = np.random.default_rng([seed, 1])
    h = cfg["ckks"]["hamming_weight_sk"]
    s = np.zeros(n, dtype=np.int64)
    s[rk.choice(n, size=h, replace=False)] = rk.choice([-1, 1], size=h)
    rc = np.random.default_rng([seed, 2])
    consts = {c: cfg["const_std"] * rc.standard_normal(slots)
              for c in const_names}
    ri = np.random.default_rng([seed, 3])
    x = ri.uniform(mix["input_low"], mix["input_high"],
                   size=(mix["pool"], n_inputs, mix["batch"], slots))
    return Draws(s, consts, x)


class Run:
    """The program set up for one cell and seed."""

    def __init__(self, cell: Dict, seed: int, device: str = "cuda",
                 ckks_override: Optional[Dict] = None,
                 t0: Optional[float] = None):
        import torch
        from repro_torch.compiler import PassConfig
        from repro_torch.compiler.engine import CkksEngine
        from repro_torch.core.ciphertext import SecretKey
        from repro_torch.core.params import CkksParams
        from repro_torch.core.pipeline import MemoryModel
        from repro_torch.core.trace import infer_levels, trace_program
        from repro_torch.runtime.compile_cache import CompileCache

        self.torch = torch
        self.t0 = time.perf_counter() if t0 is None else t0
        self.cell, self.seed = cell, seed
        cfg, mix = cell["config"], cell["traffic"]
        self.numbers = ckks_numbers(cfg, ckks_override)
        self.params = CkksParams(**self.numbers)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stamps: Dict[str, float] = {}

        self._stamp("import")
        self.fn, n_inputs, const_names = cells.program(cfg)
        self.draws = draw(cfg, mix, seed, self.params.n, n_inputs,
                          const_names)
        eng = CkksEngine(self.params, seed=seed % (1 << 63),
                         use_kernels=True, device=device)
        self._stamp("engine")
        ctx = eng.ctx
        # the harness's secret, so the reference needs nothing the
        # program drew: its NTT form and the relinearization key under it
        idx = list(range(ctx.n_q + ctx.n_p))
        limbs = self.draws.secret[None, :] % np.array(ctx.primes)[:, None]
        eng.sk = SecretKey(
            s_ntt=ctx.ntt(torch.from_numpy(limbs).to(self.device), idx),
            s_coeff_ternary=torch.from_numpy(
                self.draws.secret.astype(np.int8)).to(self.device))
        eng.rk = eng.encryptor.relin_keygen(eng.sk)
        self.engine = eng
        self._stamp("keys")

        self.start = cfg["start_level"]
        trace = trace_program(self.fn, n_inputs, const_names)
        infer_levels(trace, start_level=self.start)
        sched = CompileCache().get_schedule(
            trace, self.params, MemoryModel(**cfg["memory_model"]),
            pass_config=PassConfig(**cfg["pass_config"]))
        self.trace = sched.trace
        self.ops = [op for st in sched.stages for op in st.ops
                    if op.kind not in ("input", "const")]
        b = mix["batch"]
        bounds = bound.trace_bounds(self.trace, self.params.n, b,
                                    self.params.n_special,
                                    self.params.alpha, self.params.slots)
        self.op_bounds = [bounds[op.idx] for op in self.ops]
        self._stamp("compile")

        base = [[eng.encrypt_batch(self.draws.inputs[p, i], self.start)
                 for i in range(n_inputs)] for p in range(mix["pool"])]
        self.scale = base[0][0].scale
        n_limbs = self.start + 1
        self.q = torch.tensor(ctx.primes[:n_limbs], dtype=torch.int64,
                              device=self.device)[:, None]
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed((seed * 1000003 + 5) % (1 << 63))
        s_ntt = eng.sk.s_ntt[:n_limbs]
        self.queue = [[self._rerandomise(ct.data, s_ntt) for ct in
                       base[k % len(base)]] for k in range(mix["queue"])]
        del base
        self._sync()
        self._stamp("encrypt")
        for n in range(2):
            self.batch(self.arrive(n)[0])
        self._sync()
        self._stamp("warm")

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def _stamp(self, name: str) -> None:
        self.stamps[name] = time.perf_counter() - self.t0

    @property
    def batch_size(self) -> int:
        return self.cell["traffic"]["batch"]

    def _rerandomise(self, data, s_ntt):
        """(c0 - a s, c1 + a) for a fresh uniform a: another encryption of
        the same message."""
        torch = self.torch
        a = torch.randint(0, 1 << 62, data[:, 1].shape, generator=self.gen,
                          device=self.device) % self.q
        c0 = torch.remainder(data[:, 0] - a * s_ntt % self.q, self.q)
        c1 = torch.remainder(data[:, 1] + a, self.q)
        return torch.stack((c0, c1), 1)

    def arrive(self, n: int):
        """Batch n's inputs: queue entry n mod its length, with a constant
        T drawn per ciphertext added to every slot's value (T / scale),
        and T itself, (inputs, batch) int64."""
        torch = self.torch
        entry = self.queue[n % len(self.queue)]
        half = self.cell["traffic"]["shift"]
        u = torch.rand((len(entry), self.batch_size), generator=self.gen,
                       device=self.device, dtype=torch.float64)
        shift = torch.round((2 * u - 1) * half * self.scale).long()
        env = {}
        for i, idx in enumerate(self.trace.inputs):
            data = entry[i]
            c0 = torch.remainder(data[:, 0] + shift[i][:, None, None],
                                 self.q)
            env[idx] = _ct(torch.stack((c0, data[:, 1]), 1), self.start,
                           self.scale)
        return env, shift

    def batch(self, env: Dict) -> list:
        """One batch on the inputs in `env`, enqueued (not
        synchronised)."""
        self.engine.run_ops(self.ops, env, self.draws.consts,
                            start_level=self.start,
                            const_scope=(self.cell["name"],))
        return [env[o] for o in self.trace.outputs]

    def batch_traced(self, env: Dict) -> list:
        from torch.profiler import record_function
        for op in self.ops:
            with record_function(devtrace.OP_PREFIX + op.kind):
                self.engine.run_ops([op], env, self.draws.consts,
                                    start_level=self.start,
                                    const_scope=(self.cell["name"],))
        return [env[o] for o in self.trace.outputs]

    def _keep(self) -> "_Keep":
        return _Keep(self.cell["traffic"]["checked"], self.seed)

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float) -> Dict:
        """Batches back to back for `seconds`, and at least as many as the
        check samples; each batch's latency from CUDA events around it
        (host clock on the CPU). A batch's successor arrives behind it on
        the device, so the host waits for the batch alone."""
        torch = self.torch
        keep = self._keep()
        lat_ms: List[float] = []
        n = 0
        self._sync()
        t0 = time.perf_counter()
        self.stamps["window_start"] = t0 - self.t0
        env, shift = self.arrive(0)
        while True:
            if self.cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = self.batch(env)
                e1.record()
                nxt = self.arrive(n + 1)
                e1.synchronize()
                lat_ms.append(e0.elapsed_time(e1))
            else:
                h0 = time.perf_counter()
                out = self.batch(env)
                lat_ms.append((time.perf_counter() - h0) * 1e3)
                nxt = self.arrive(n + 1)
            keep.offer(n, shift, out)
            n += 1
            if time.perf_counter() - t0 >= seconds and n >= keep.size:
                break
            env, shift = nxt
        window_s = time.perf_counter() - t0
        return {"batches": n, "cts": n * self.batch_size,
                "window_s": window_s, "lat_ms": lat_ms,
                "setup_s": self.stamps["window_start"], "keep": keep}

    def traced_window(self, seconds: float) -> Dict:
        """The window with every op in its own profiler range, and each
        request's arrival in one of its own."""
        from torch.profiler import ProfilerActivity, profile, record_function
        torch = self.torch
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        keep = self._keep()
        n = 0
        with profile(activities=acts) as prof:
            self._sync()
            t0 = time.perf_counter()
            with record_function(devtrace.ARRIVE):
                env, shift = self.arrive(0)
            while True:
                with record_function(devtrace.BATCH):
                    out = self.batch_traced(env)
                    done = torch.cuda.Event() if self.cuda else None
                    if done is not None:
                        done.record()
                    with record_function(devtrace.ARRIVE):
                        nxt = self.arrive(n + 1)
                    if done is not None:
                        done.synchronize()
                keep.offer(n, shift, out)
                n += 1
                if time.perf_counter() - t0 >= seconds and n >= keep.size:
                    break
                env, shift = nxt
        t = time.perf_counter()
        red = devtrace.reduce(devtrace.records(prof), self.batch_size,
                              self.op_bounds)
        red["reduce_s"] = time.perf_counter() - t
        red["cts"] = n * self.batch_size
        red["keep"] = keep
        return red

    # -- after the window ----------------------------------------------------

    def outputs(self, keep: "_Keep") -> Dict:
        """The sampled batches' outputs and shifts on the host, and the
        device memory peak; frees the program's state."""
        torch = self.torch
        peak = torch.cuda.max_memory_allocated() if self.cuda else 0
        host = []
        for n, shift, outs in keep.sample:
            host.append({"batch": n, "base": n % len(self.queue)
                         % self.cell["traffic"]["pool"],
                         "shift": shift.cpu().numpy() / self.scale,
                         "outs": [(o.data.cpu().numpy(), o.level, o.scale)
                                  for o in outs]})
        self.queue = []
        self.engine = None
        keep.sample.clear()
        if self.cuda:
            torch.cuda.empty_cache()
        return {"host": host, "peak": peak}


def _ct(data, level: int, scale: float):
    from repro_torch.compiler.engine import CtBatch
    return CtBatch(data, level, scale)


class _Keep:
    """`size` batches of the window drawn from the seed (a reservoir),
    with their shifts and outputs."""

    def __init__(self, size: int, seed: int):
        self.rng = np.random.default_rng([seed % (1 << 63), 4])
        self.size = size
        self.sample: List = []
        self.count = 0

    def offer(self, n: int, shift, out: list) -> None:
        self.count += 1
        if len(self.sample) < self.size:
            self.sample.append((n, shift, out))
        else:
            j = int(self.rng.integers(self.count))
            if j < self.size:
                self.sample[j] = (n, shift, out)


def measure(numbers: Dict, draws: Draws, fn, got: Dict, tol: float,
            device="cpu") -> Dict:
    """Decrypt the sampled outputs with the reference and compare them
    with the program's source evaluated on the same slot vectors: the
    base batch's inputs plus each ciphertext's shift.

    Held to limits, per ciphertext (row) and the largest over the rows:
    `row_tail_pct`, the share of its slots, in %, whose |decrypted -
    reference| exceeds `tol` times the RMS of the reference values (the
    configuration states `tol`, the precision it promises a slot); and
    `row_max_err`, its largest slot error over the same RMS. Kept as
    readings: per row the 90th percentile of the error over the same RMS
    (`row_p90_err`), and the RMS of that relative error."""
    q, _ = ref.prime_chain(numbers)
    errs, wants = [], []
    bad = 0
    top = max(d.shape[2] for b in got["host"] for d, _, _ in b["outs"])
    s_ev = ref.secret_eval(draws.secret, q[:top], device)
    for b in got["host"]:
        x = draws.inputs[b["base"]] + b["shift"][:, :, None]
        want = ref.evaluate(fn, x, draws.consts)
        for (data, _level, scale), w in zip(b["outs"], want):
            z, nbad = ref.decrypt(data, scale, s_ev, q)
            bad += nbad
            errs.append(np.abs(z - w))
            wants.append(np.abs(w))
    out = {"batches": len(got["host"]), "bad_coeffs": bad}
    e = np.concatenate(errs)
    rms_w = float(np.sqrt((np.concatenate(wants) ** 2).mean()))
    rel = e / rms_w
    out["row_tail"] = (100.0 * (rel > tol).mean(-1)).tolist()
    out["row_max"] = rel.max(-1).tolist()
    out["row_tail_pct"] = max(out["row_tail"])
    out["row_max_err"] = max(out["row_max"])
    out["row_p90_err"] = float(np.quantile(rel, 0.9, axis=-1).max())
    out["rel_rms_err"] = float(np.sqrt((rel ** 2).mean()))
    out["rms_want"] = rms_w
    return out


EXACT = ("bad_coeffs",)
LIMITED = ("row_tail_pct", "row_max_err")
ROWS = {"row_tail_pct": "row_tail", "row_max_err": "row_max"}


def judge(readings: Dict, limits: Dict) -> Dict:
    """Each number compared beside its limit, `correct`, and the rows
    (ciphertexts) that failed. The exact numbers have the limit 0; a
    number without a limit fails."""
    nums = {k: (readings[k], 0) for k in EXACT}
    nums.update({k: (readings[k], limits.get(k)) for k in LIMITED})
    ok = bool(readings["row_tail"]) and all(
        lim is not None and val <= lim for val, lim in nums.values())
    if ok:
        return {"correct": True, "numbers": nums, "rows_failed": 0}
    bad_rows = set()
    for k, rows in ROWS.items():
        lim = limits.get(k)
        bad_rows |= {i for i, r in enumerate(readings[rows])
                     if lim is None or not r <= lim}
    return {"correct": False, "numbers": nums,
            "rows_failed": max(1, len(bad_rows))}


def cell_limits(cell: Dict) -> Dict:
    """The limits of a cell's numbers: its limits file, and the worst slot
    error its configuration states."""
    return {**cells.limits(cell["name"]),
            "row_max_err": cell["config"]["slot_max_tol"]}


def execute(cell: Dict, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t0: Optional[float] = None,
            ckks_override: Optional[Dict] = None,
            limits: Optional[Dict] = None) -> Dict:
    """Set up, run the window, read the metrics, check. Returns the
    result object (see bench/run.py) and, under `extra`, the set-up
    stamps and what the readers were given."""
    run = Run(cell, seed, device, ckks_override, t0)
    rec = run.traced_window(seconds) if trace else run.window(seconds)
    keep = rec.pop("keep")
    got = run.outputs(keep)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = cells.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    t = time.perf_counter()
    readings = measure(run.numbers, run.draws, run.fn, got,
                       cell["config"]["slot_tol"], run.device)
    chk = judge(readings, cell_limits(cell) if limits is None else limits)
    check_s = time.perf_counter() - t
    dev = {"platform": "gpu" if run.cuda else "cpu",
           "kind": _device_name(run), "count": cell["chips"],
           "memory_peak_bytes": got["peak"]}
    out = {"correct": chk["correct"], "attempted": rec["cts"],
           "failed": chk["rows_failed"],
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec.get("busy_s", 0.0)
        dev["window_s"] = rec.get("window_s", 0.0)
        out["breakdown"] = devtrace.breakdown(rec)
    out["check"] = {k: {"value": v, "limit": lim}
                    for k, (v, lim) in chk["numbers"].items()}
    out["extra"] = {"stamps": run.stamps, "check_s": check_s,
                    "readings": {k: v for k, v in readings.items()
                                 if k not in ("row_tail", "row_max")},
                    "rows": len(readings["row_tail"]),
                    "record": {k: v for k, v in rec.items()
                               if k not in ("lat_ms", "by_name")}}
    return out


def _device_name(run: Run) -> str:
    if run.cuda:
        return run.torch.cuda.get_device_name(run.device)
    return "cpu"


def report(out: Dict) -> None:
    """Standard error: the run's notes, then each number compared beside
    its limit as the last lines. Standard output: the result line, whose
    last key is `check` once `extra` is taken out."""
    import sys
    extra = out.pop("extra")
    print("bench: " + json.dumps(extra, default=float), file=sys.stderr)
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))

"""In-process A/B of the serving engine on the card.

    python3 serve_ab.py OTHER_ENGINE_PY [--pairs N] [--out DIR]

Loads OTHER_ENGINE_PY (another tree's ``rocm_apex_tpu_torch/inference/
engine.py``, which must speak this tree's model and cache API) beside
this tree's engine and builds chip_smoke.py's serve cell from each: the
bench.py serve widths in bf16, 8 slots, capacity 1024, budget 256,
greedy, on the contiguous cache and on bf16 pages of 16. Every engine is
warmed, then the serve's 32 requests x 64 new tokens run on each in
turn, A B B A, for ``--pairs`` pairs (A is this tree's engine, B the
other). One process and one model serve both, so host placement, the
allocator and the clocks are shared: the A/B reads the engines'
difference, not the spread between processes. Checks that both engines
give the same greedy tokens; prints each run's generated tokens/s and
its mixed and decode-only tick ms, then the medians and the B / A
ratios, and writes them to ``DIR/serve_ab.json``.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

import torch

import chip_smoke as cs

FORMS = (("contiguous", {}), ("bf16_pages", dict(paged=True,
                                                 page_size=cs.PAGE_SIZE)))
METRICS = ("tokens_per_s", "mixed_tick_ms", "decode_tick_ms")


def load_engine(path):
    """The InferenceEngine class of ``path``, imported as a module of
    this tree's package (its absolute imports resolve here)."""
    name = "rocm_apex_tpu_torch.inference._engine_b"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod.InferenceEngine


def serve_once(eng, prompts):
    """The serve's requests on a warm engine: (metrics, tokens)."""
    eng.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [eng.add_request(p, cs.MAX_NEW) for p in prompts]
    done = {}
    while eng.has_work():
        for r in eng.step():
            done[r.request_id] = r
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tokens = [done[i].tokens for i in ids]
    s = eng.stats()
    return dict(tokens_per_s=sum(map(len, tokens)) / dt,
                mixed_tick_ms=s["prefill_ms_avg"],
                decode_tick_ms=s["decode_ms_avg"]), tokens


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other tree's inference/engine.py")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", help="directory for serve_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    from rocm_apex_tpu_torch.inference import InferenceEngine, SamplingParams
    from rocm_apex_tpu_torch.ops import _build

    cs.log(cs.smi_line())
    _build.build_all()
    engines = {"A": InferenceEngine, "B": load_engine(args.other)}
    model, _ = cs._serve_model()
    prompts = cs.serve_prompts(model.cfg.vocab_size)
    report = {"nvidia_smi": cs.smi_line(), "pairs": args.pairs, "forms": {}}
    for form, kw in FORMS:
        eng = {k: cls(model, num_slots=cs.SLOTS, capacity=cs.CAPACITY,
                      prefill_token_budget=cs.BUDGET,
                      sampling=SamplingParams(temperature=0.0), **kw)
               for k, cls in engines.items()}
        for e in eng.values():
            e.generate(prompts[:cs.SLOTS], max_new_tokens=3)
        runs = {"A": [], "B": []}
        tokens = {}
        order = "".join("AB" if i % 2 == 0 else "BA"
                        for i in range(args.pairs))
        for k in order:
            r, tokens[k] = serve_once(eng[k], prompts)
            runs[k].append(r)
            cs.log(f"  {form} {k}: {r['tokens_per_s']:.1f} tok/s, mixed "
                   f"{r['mixed_tick_ms']:.3f} ms, decode-only "
                   f"{r['decode_tick_ms']:.3f} ms")
        cs.check(tokens["A"] == tokens["B"],
                 f"{form}: the two engines' greedy tokens differ")
        med = {k: {m: statistics.median(r[m] for r in rs) for m in METRICS}
               for k, rs in runs.items()}
        ratio = {m: med["B"][m] / med["A"][m] for m in METRICS}
        cs.log(f"  {form} median A {med['A']}; B {med['B']}; B / A {ratio}")
        report["forms"][form] = dict(runs=runs, median=med,
                                     ratio_b_over_a=ratio)
        del eng
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "serve_ab.json"), "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({m: {f: r["ratio_b_over_a"][m]
                          for f, r in report["forms"].items()}
                      for m in METRICS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

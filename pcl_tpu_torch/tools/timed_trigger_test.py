"""CLI: exercise the fixed-interval TimeTrigger (counterpart of
``pcl_tpu/tools/timed_trigger_test.py``; reference
tools/timed_trigger_test.cpp): two callbacks fire for a while.

    python -m pcl_tpu_torch.tools.timed_trigger_test -interval 0.05 -duration 0.3
"""
import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="TimeTrigger smoke test")
    ap.add_argument("-interval", type=float, default=0.05)
    ap.add_argument("-duration", type=float, default=0.3)
    args = ap.parse_args(argv)
    from pcl_tpu_torch.utils import TimeTrigger
    fired = []
    trig = TimeTrigger(args.interval, lambda: fired.append(time.perf_counter()))
    trig.register_callback(lambda: None)   # a second callback, as the reference has
    trig.start()
    time.sleep(args.duration)
    trig.stop()
    print(f"[timed_trigger_test] {len(fired)} firings in {args.duration}s "
          f"at interval {args.interval}s")
    return 0 if fired else 1


if __name__ == "__main__":
    sys.exit(main())

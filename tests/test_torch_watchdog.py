"""The port's collective watchdog (``distributed/communication/
watchdog.py``, the reference's ladder) on a real hang: two gloo ranks in
processes, rank 0 waits in a ``barrier`` that rank 1 never reaches.

With ``FLAGS comm_timeout_s`` = 2 s on rank 0, its stderr must show the
warn stage at half the deadline, the dump stage (the stacks and the
flight recorder's last collectives) at three quarters, and the abort at
the deadline, after which rank 0 exits 124 for the launcher to relaunch;
each stage fires within one poll (0.25 s here) of its fraction.
"""
import re

import torch_dist_ranks as R

TIMEOUT_S = 2.0
POLL_S = 0.25 + 0.25  # the watchdog's poll at this deadline, and slack


def test_warn_dump_abort_come_at_their_fractions(tmp_path):
    out = R.run_ranks(R.watchdog_body, 2, tmp_path, args=(TIMEOUT_S,),
                      timeout=60, expect_exit=[124, 0])
    err = (out / "rank0.stderr").read_text()
    warn = re.search(r"wait 'barrier\(group=0\)' has consumed 50% of its "
                     r"deadline \(([\d.]+)s\)", err)
    dump = re.search(r"wait 'barrier\(group=0\)' at 75% of its deadline "
                     r"\(([\d.]+)s\)", err)
    abort = re.search(r"wait 'barrier\(group=0\)' exceeded its deadline "
                      r"\(([\d.]+)s\)", err)
    assert warn and dump and abort, err[-3000:]
    for m, frac in ((warn, 0.5), (dump, 0.75), (abort, 1.0)):
        age = float(m.group(1))
        assert frac * TIMEOUT_S - 0.05 <= age <= frac * TIMEOUT_S + POLL_S, (
            frac, age)
    assert warn.start() < dump.start() < abort.start()
    assert "aborting (exit 124)" in err
    # the dump stage printed this rank's last collectives
    assert "all_reduce[sum]" in err and "barrier" in err

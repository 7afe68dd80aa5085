"""The card: the share of the profiled rounds' span in which no kernel,
copy or fill ran on it, in %."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

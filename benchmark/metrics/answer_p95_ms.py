"""answer_p95_ms: the 95th percentile (nearest rank) of every request due in
the window, from when the open-loop schedule made it due to the host
readback of its answer; a failed or refused request counts as missing
(infinite)."""

import math


def read(obs):
    lat = obs.get("latencies_ms")
    if not lat:
        return None
    ranked = sorted(lat)
    p95 = ranked[math.ceil(0.95 * len(ranked)) - 1]
    return p95 if math.isfinite(p95) else 1e30

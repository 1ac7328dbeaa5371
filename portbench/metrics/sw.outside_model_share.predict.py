"""Share (%) of a volume's time spent outside the model's calls: bucket
padding, the window stack, the Gaussian blend, the argmax and the read-back
(infer/sliding_window.py, cli/run_test.py). 100 x (1 - the calls' device
seconds / the volumes' host seconds), over the window's volumes outside the
profiled sub-window."""

from portbench.readers import calls, outside


def read(rec):
    vols = [s for i, s in enumerate(rec.host.get("volume", []))
            if outside(rec, i)]
    c = calls(rec)
    if not vols or not c:
        return None
    model_s = sum(ms for ms, _, _ in c) / 1e3
    return 100.0 * (1.0 - model_s / sum(vols))

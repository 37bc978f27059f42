"""mfu.serve: the least time of one denoise step's work (its operations at
the peak of each one's precision, ``arith.forward_work``) over the measured
step time, in %. Read in the denoise cells."""


def read(t):
    if not t or t.get("kind") != "serve":
        return None
    return 100.0 * t["least_s_per_step"] / t["step_s"]

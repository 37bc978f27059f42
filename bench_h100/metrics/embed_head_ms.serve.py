"""embed_head_ms.serve: the device milliseconds a step of the program's
``dit.forward`` span, exclusive of the blocks (``bench_h100/spans.py``'s
credit): the patch and text embeddings, the time MLP and its per-frame table,
the pad and rope tables, the head. Read where the job credits its trace to
the spans (the ti2v cell); nothing without them."""

SPAN = "dit.forward"


def read(t):
    if not t or t.get("kind") != "serve" or SPAN not in t.get("spans", {}):
        return None
    return 1e3 * t["spans"][SPAN][0] / t["steps"]

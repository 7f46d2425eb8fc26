from trlx_tpu_torch.utils.aotjit import aot_jit


def make_runner(fn):
    step = aot_jit(fn)

    def run(xs):
        out = []
        for x in xs:
            out.append(step(x))
        return out

    return run


def bucketed(fn, shapes):
    cache = {}
    for shape in shapes:
        if shape not in cache:
            cache[shape] = make_runner(fn)
    return cache

from trlx_tpu_torch.utils import aotjit


def compile_all(fns):
    out = []
    for fn in fns:
        out.append(aotjit.aot_jit(fn))
    return out

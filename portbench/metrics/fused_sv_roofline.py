"""Share of its roofline that the f32 fused kernel (csrc/fused_sv.cu,
``fused_pass_kernel``) reaches over the traced window, in %."""

from portbench import roofline


def read(rec):
    return roofline.kernel_share(rec, "fused_pass_kernel", "fused_sv", False,
                                 "fused_sv_fresh")

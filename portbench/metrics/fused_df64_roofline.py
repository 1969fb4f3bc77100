"""Share of its roofline that the df64 fused kernel (csrc/fused_df64.cu,
``fused_pass_df64_kernel``) reaches over the traced window, in %."""

from portbench import roofline


def read(rec):
    return roofline.kernel_share(rec, "fused_pass_df64_kernel", "fused_df64",
                                 True)

"""The port's kernel names as the profiler reports them (substrings of
the demangled names), by layer."""

# device pass A: csrc/passa.cu
WALK = ("passa_kernel",)
# device pass B: csrc/splat.cu, itxfm.cu (scatter, residual, the 10/12-bit
# residual), mc.cu, intra.cu, lf_grids.cu, lpf.cu
PASS_B = ("splat_index_kernel", "splat_gather_kernel", "scatter_kernel",
          "residual_kernel", "mc_kernel", "mc_scaled_kernel", "intra_kernel",
          "lf_grids_kernel", "lpf_kernel")
# one launch a frame of pass B: the residual of the frame's three planes
# (residual_kernel or residual_kernel_hbd)
PASS_B_FRAME = ("residual_kernel",)

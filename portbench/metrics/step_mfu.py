"""The whole step's share of the card's peak: model FLOPs of the window
(B x iterations x GEMMs an iteration x 8 N^3 a step) over its host
seconds times the fastest the H100 multiplies matrices of the state's
precision, in %."""

from portbench.yardstick import PEAK_MATMUL_FLOPS_PER_S, gemm_flops_per_step


def read(run):
    its = run.iterations_per_step()
    if not its:
        return None
    flops = gemm_flops_per_step(
        run.N, run.batch, its,
        run.cell.config["gemms_per_iteration"]) * run.window_steps
    return 100.0 * flops / (run.window_s
                            * PEAK_MATMUL_FLOPS_PER_S[run.dtype.name])

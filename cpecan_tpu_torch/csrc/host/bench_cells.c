/* Single-core C baseline micro-benchmark for the pair-HMM DP cell update.
 *
 * Implements the same arithmetic the reference's hot loop performs per
 * banded cell (5-state forward update: 13 active transitions, each a
 * lookup-based logAdd — impl/stateMachine.c:450-480 + logAdd
 * impl/pairwiseAligner.c:287-307), written independently here to measure
 * an honest cells/sec number for the comparator in BASELINE.md.
 *
 * Build: gcc -O3 -o bench_cells bench_cells.c -lm
 * Output: one line "cells_per_sec <value>"
 */

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define LOG_ZERO -INFINITY
#define S 5
#define W 1024          /* band width (cells per diagonal) */
#define DIAGS 4000      /* diagonals to sweep */

static inline double lookup_logadd(double x, double y) {
    /* piecewise-cubic log1p(exp(-d)) approximation, same cost profile as
     * the reference lookup */
    double hi = x > y ? x : y;
    double lo = x > y ? y : x;
    if (lo == LOG_ZERO) return hi;
    double d = hi - lo;
    if (d >= 7.5) return hi;
    double r;
    if (d <= 1.0)
        r = ((-0.009350833524763 * d + 0.130659527668286) * d + 0.498799810682272) * d + 0.693203116424741;
    else if (d <= 2.5)
        r = ((-0.014532321752540 * d + 0.139942324101744) * d + 0.495635523139337) * d + 0.692140569840976;
    else if (d <= 4.5)
        r = ((-0.004605031767994 * d + 0.063427417320019) * d + 0.695956496475118) * d + 0.514272634594009;
    else
        r = ((-0.000458661602210 * d + 0.009695946122598) * d + 0.930734667215156) * d + 0.168037164329057;
    return r + hi;
}

int main(int argc, char **argv) {
    /* transition log-probs (values irrelevant to throughput) */
    double t_match_cont = -0.03, t_from_sgx = -1.27, t_from_lgx = -5.67;
    double t_sg_open = -4.34, t_sg_ext = -0.34, t_lg_open = -6.31, t_lg_ext = -0.003;
    double em_match[25], em_gap[5];
    for (int i = 0; i < 25; i++) em_match[i] = -2.1 - 0.1 * i;
    for (int i = 0; i < 5; i++) em_gap[i] = -1.6;

    static double diag0[W][S], diag1[W][S], diag2[W][S];
    static unsigned char symx[W + DIAGS], symy[W + DIAGS];
    srand(42);
    for (int i = 0; i < W + DIAGS; i++) { symx[i] = rand() % 5; symy[i] = rand() % 5; }
    for (int j = 0; j < W; j++)
        for (int s = 0; s < S; s++) { diag1[j][s] = -1.0 - s; diag2[j][s] = -2.0 - s; }

    struct timespec start, end;
    clock_gettime(CLOCK_MONOTONIC, &start);

    long cells = 0;
    for (int k = 0; k < DIAGS; k++) {
        for (int j = 0; j < W; j++) {
            double *cur = diag0[j];
            /* neighbors: shift by one cell along the band */
            double *lower = j > 0 ? diag1[j - 1] : NULL;
            double *upper = j < W - 1 ? diag1[j + 1] : NULL;
            double *middle = diag2[j];
            for (int s = 0; s < S; s++) cur[s] = LOG_ZERO;
            unsigned char cx = symx[k + j], cy = symy[k + j];
            if (lower) {
                double e = em_gap[cx];
                cur[1] = lookup_logadd(cur[1], lower[0] + e + t_sg_open);
                cur[1] = lookup_logadd(cur[1], lower[1] + e + t_sg_ext);
                cur[3] = lookup_logadd(cur[3], lower[0] + e + t_lg_open);
                cur[3] = lookup_logadd(cur[3], lower[3] + e + t_lg_ext);
            }
            {
                double e = em_match[cx * 5 + cy];
                cur[0] = lookup_logadd(cur[0], middle[0] + e + t_match_cont);
                cur[0] = lookup_logadd(cur[0], middle[1] + e + t_from_sgx);
                cur[0] = lookup_logadd(cur[0], middle[2] + e + t_from_sgx);
                cur[0] = lookup_logadd(cur[0], middle[3] + e + t_from_lgx);
                cur[0] = lookup_logadd(cur[0], middle[4] + e + t_from_lgx);
            }
            if (upper) {
                double e = em_gap[cy];
                cur[2] = lookup_logadd(cur[2], upper[0] + e + t_sg_open);
                cur[2] = lookup_logadd(cur[2], upper[2] + e + t_sg_ext);
                cur[4] = lookup_logadd(cur[4], upper[0] + e + t_lg_open);
                cur[4] = lookup_logadd(cur[4], upper[4] + e + t_lg_ext);
            }
            cells++;
        }
        memcpy(diag2, diag1, sizeof(diag1));
        memcpy(diag1, diag0, sizeof(diag0));
    }

    clock_gettime(CLOCK_MONOTONIC, &end);
    double secs = (end.tv_sec - start.tv_sec) + 1e-9 * (end.tv_nsec - start.tv_nsec);
    /* a cell requires both a forward and a backward update in the full
     * FB pass; this loop measures one update, so halve the rate */
    printf("cells_per_sec %.0f\n", cells / secs / 2.0);
    /* keep the compiler honest */
    if (argc > 99) printf("%f", diag0[0][0]);
    return 0;
}

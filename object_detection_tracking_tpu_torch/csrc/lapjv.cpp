// Jonker-Volgenant linear assignment solver (dense, square).
//
// Native replacement for the third-party `lap.lapjv` the reference depends
// on for TMOT association and multi-camera ReID (tmot/matching.py:26-37,
// multi_video_reid.py:512-534). Exposed via ctypes from
// tracking/assignment.py, which builds it with g++ at first use.
//
// R. Jonker and A. Volgenant, "A Shortest Augmenting Path Algorithm for
// Dense and Sparse Linear Assignment Problems", Computing 38, 1987.
//
// Build: g++ -O3 -shared -fPIC -o liblapjv.so lapjv.cpp

#include <cfloat>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// cost: n*n row-major. x[i] = column assigned to row i. y[j] = row assigned
// to column j. Returns the optimal total cost.
double lapjv_dense(int n, const double* cost, int* x, int* y) {
    std::vector<double> v(n, 0.0);       // column potentials
    std::vector<int> free_rows(n);
    int num_free = 0;

    for (int i = 0; i < n; ++i) x[i] = -1;
    for (int j = 0; j < n; ++j) y[j] = -1;

    // --- column reduction (scan columns right-to-left)
    for (int j = n - 1; j >= 0; --j) {
        double min_c = cost[0 * n + j];
        int imin = 0;
        for (int i = 1; i < n; ++i) {
            const double c = cost[i * n + j];
            if (c < min_c) { min_c = c; imin = i; }
        }
        v[j] = min_c;
        if (x[imin] == -1) {
            x[imin] = j;
            y[j] = imin;
        }
    }

    // rows still unassigned after column reduction
    for (int i = 0; i < n; ++i)
        if (x[i] == -1) free_rows[num_free++] = i;

    // --- augmenting row reduction (two sweeps)
    for (int sweep = 0; sweep < 2 && num_free > 0; ++sweep) {
        int k = 0, new_free = 0;
        while (k < num_free) {
            const int i = free_rows[k++];
            double u1 = DBL_MAX, u2 = DBL_MAX;
            int j1 = -1, j2 = -1;
            for (int j = 0; j < n; ++j) {
                const double h = cost[i * n + j] - v[j];
                if (h < u1) { u2 = u1; j2 = j1; u1 = h; j1 = j; }
                else if (h < u2) { u2 = h; j2 = j; }
            }
            int i0 = y[j1];
            if (u1 < u2) {
                v[j1] -= u2 - u1;
            } else if (i0 >= 0) {
                j1 = j2;
                i0 = y[j1];
            }
            x[i] = j1;
            y[j1] = i;
            if (i0 >= 0) {
                x[i0] = -1;
                if (u1 < u2) {
                    free_rows[--k] = i0;       // re-process immediately
                } else {
                    free_rows[new_free++] = i0; // defer to next sweep
                }
            }
        }
        num_free = new_free;
    }

    // --- augmentation: shortest augmenting path (Dijkstra) per free row
    std::vector<double> d(n);
    std::vector<int> pred(n);
    std::vector<char> done(n);
    for (int f = 0; f < num_free; ++f) {
        const int istart = free_rows[f];
        std::memset(done.data(), 0, n);
        for (int j = 0; j < n; ++j) {
            d[j] = cost[istart * n + j] - v[j];
            pred[j] = istart;
        }
        int jsel = -1;
        double mind = 0.0;
        std::vector<int> scanned;
        for (;;) {
            // find nearest unscanned column
            mind = DBL_MAX;
            for (int j = 0; j < n; ++j)
                if (!done[j] && d[j] < mind) { mind = d[j]; jsel = j; }
            done[jsel] = 1;
            scanned.push_back(jsel);
            if (y[jsel] == -1) break;      // free column: augmenting path
            const int i = y[jsel];
            for (int j = 0; j < n; ++j) {
                if (done[j]) continue;
                const double nd = mind + cost[i * n + j] - v[j]
                                  - (cost[i * n + jsel] - v[jsel]);
                if (nd < d[j]) { d[j] = nd; pred[j] = i; }
            }
        }
        // update potentials along scanned columns
        for (int s = 0; s < (int)scanned.size(); ++s) {
            const int j = scanned[s];
            if (j == jsel) continue;
            v[j] += d[j] - mind;
        }
        // augment along the alternating path
        int j = jsel;
        for (;;) {
            const int i = pred[j];
            y[j] = i;
            const int jnext = x[i];
            x[i] = j;
            if (i == istart) break;
            j = jnext;
        }
    }

    double total = 0.0;
    for (int i = 0; i < n; ++i) total += cost[i * n + x[i]];
    return total;
}

}  // extern "C"

// Native GAF traceback + emission for POA modes 0-3.
//
// C++ port of recgraph_tpu/oracle/gaf_emit.py (itself a port of the
// reference's src/gaf_output.rs walkers) operating directly on the
// packed direction planes produced by the device kernels:
//   cell = packed[row*stride + band_rel_col + lefts[row]]
//   pred = cell >> 4, dir = cell & 15  (codes O,D,d,L,U,X,Y,M,u = 0..8)
//
// The device fill is the throughput side; this walker is the host-side
// hot loop (one O(|alignment|) walk + string build per read), kept
// native so GAF emission keeps up with the device engines.
//
// Exposed C ABI (ctypes):
//   gaf_emit_poa(...)        -> bytes written into out (excl. NUL), <0 on error
//   band_check_linear(...)   -> 1 ok / 0 band insufficient (global_abpoa.rs:428-476)
//   band_check_gap(...)      -> 1 ok / 0                   (gap_global_abpoa.rs:371-455)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <thread>

namespace {

enum Dir : int32_t { O = 0, DD = 1, dd = 2, LL = 3, UU = 4, XX = 5, YY = 6, MM = 7, uu = 8 };

inline int upper(int d) {
    if (d == dd) return DD;
    if (d == uu) return UU;
    return d;
}

struct Plane {
    const int32_t* data;
    const int32_t* lefts;  // may be null (full-width)
    int64_t stride;
    inline int32_t cell(int64_t row, int64_t col) const {
        int64_t off = lefts ? lefts[row] : 0;
        return data[row * stride + col + off];
    }
    inline int32_t pred(int64_t row, int64_t col) const { return cell(row, col) >> 4; }
    inline int32_t dir(int64_t row, int64_t col) const { return cell(row, col) & 15; }
};

// gaf_output.rs:876-892
bool set_cigar_substring(long cm, long ci, long cd, std::string& cs) {
    if (cm * ci + ci * cd + cm * cd != 0) return false;
    char buf[32];
    if (cm > 0) {
        snprintf(buf, sizeof buf, "%ldM", cm);
        cs.insert(0, buf);
    } else if (ci > 0) {
        snprintf(buf, sizeof buf, "%ldI", ci);
        cs.insert(0, buf);
    } else if (cd > 0) {
        snprintf(buf, sizeof buf, "%ldD", cd);
        cs.insert(0, buf);
    }
    return true;
}

// gaf_output.rs:867-874
int64_t node_start(const int64_t* hofp, int64_t row) {
    int64_t id = hofp[row];
    int64_t i = row;
    while (hofp[i] == id && i > 0) i--;
    return row - i;
}

struct Emit {
    std::vector<int64_t> handles;       // appended during the walk
    std::vector<std::string> cigars;    // built back-to-front
    std::string cigar;
    long cm = 0, ci = 0, cd = 0;
    int64_t curr_handle = INT64_MIN;
    int last_dir = -1;
    long path_length = 0;
    long residue_matching = 0;
    bool ok = true;

    inline void boundary(int64_t handle, int dir) {
        if (handle != curr_handle) {
            if (!set_cigar_substring(cm, ci, cd, cigar)) { ok = false; return; }
            cigars.push_back(cigar);
            cigar.clear();
            cm = ci = cd = 0;
        }
        curr_handle = handle;
        if (last_dir < 0 || upper(dir) != upper(last_dir)) {
            if (!set_cigar_substring(cm, ci, cd, cigar)) { ok = false; return; }
            cm = ci = cd = 0;
        }
        last_dir = dir;
    }

    void finish() {
        if (!set_cigar_substring(cm, ci, cd, cigar)) { ok = false; return; }
        cigars.push_back(cigar);
    }
};

int64_t render(const Emit& em, int64_t query_length, int64_t query_start,
               int64_t query_end, bool amb, int64_t path_start,
               int64_t path_end, char* out, int64_t cap) {
    // dedup consecutive handles then reverse (Rust Vec::dedup + reverse)
    std::vector<int64_t> dedup;
    for (int64_t h : em.handles)
        if (dedup.empty() || dedup.back() != h) dedup.push_back(h);
    std::string path;
    for (auto it = dedup.rbegin(); it != dedup.rend(); ++it) {
        path += '>';
        path += std::to_string(*it);
    }
    if (dedup.empty()) path = ">";  // matches ">" + "".join([])

    std::string comments;
    for (size_t k = em.cigars.size(); k-- > 1;) {  // reversed, drop last fragment
        comments += em.cigars[k];
        if (k != 1) comments += ',';
    }

    char head[256];
    int hn = snprintf(head, sizeof head,
                      "%lld\t%lld\t%lld\t%c\t", (long long)query_length,
                      (long long)query_start, (long long)query_end,
                      amb ? '-' : '+');
    std::string line;
    line.reserve(256 + path.size() + comments.size());
    line.append(head, hn);
    line += path;
    char mid[256];
    int mn = snprintf(mid, sizeof mid, "\t%ld\t%lld\t%lld\t%ld\t*\t*\t",
                      em.path_length, (long long)path_start,
                      (long long)path_end, em.residue_matching);
    line.append(mid, mn);
    line += comments;
    if ((int64_t)line.size() + 1 > cap) return -2;
    memcpy(out, line.data(), line.size());
    out[line.size()] = 0;
    return (int64_t)line.size();
}

}  // namespace

extern "C" {

// Modes: 0 global (banded), 1 local, 2 gap global (banded), 3 gap local.
int64_t gaf_emit_poa(int32_t mode, const int32_t* packed, const int32_t* packed_x,
                     const int32_t* packed_y, const int32_t* lefts,
                     const int64_t* hofp, int64_t n, int64_t stride,
                     int64_t last_row, int64_t last_col, int64_t seq_len,
                     int32_t amb, char* out, int64_t cap) {
    const bool banded = (mode == 0 || mode == 2);
    const bool gap = (mode == 2 || mode == 3);
    Plane p{packed, banded ? lefts : nullptr, stride};
    Plane px{packed_x, banded ? lefts : nullptr, stride};
    Plane py{packed_y, banded ? lefts : nullptr, stride};

    Emit em;
    int64_t row = last_row, col = last_col;
    while (p.dir(row, col) != O) {
        int32_t cell = p.cell(row, col);
        int32_t pred = cell >> 4, dir = cell & 15;
        em.boundary(hofp[row], dir);
        if (!em.ok) return -1;
        int64_t j_pos = banded ? (col + lefts[row] - lefts[pred]) : col;
        switch (dir) {
            case DD:
                em.handles.push_back(hofp[row]);
                row = pred; col = banded ? j_pos - 1 : col - 1;
                em.cm++; em.path_length++; em.residue_matching++;
                break;
            case dd:
                em.handles.push_back(hofp[row]);
                row = pred; col = banded ? j_pos - 1 : col - 1;
                em.cm++; em.path_length++;
                break;
            case LL:
                if (gap && px.dir(row, col) == XX) {
                    // no col guard, as in gaf_output.rs:232-235/:321-327
                    // (column 0 cells are 'O' so the chain terminates)
                    while (px.dir(row, col) == XX) { em.cd++; col--; }
                } else {
                    em.cd++; col--;
                }
                break;
            case UU: {
                if (gap && py.dir(row, col) == YY) {
                    while (py.dir(row, col) == YY) {
                        int64_t pr = py.pred(row, col);
                        em.handles.push_back(hofp[row]);
                        em.ci++; em.path_length++;
                        if (banded) col = col + lefts[row] - lefts[pr];
                        row = pr;
                    }
                } else {
                    em.handles.push_back(hofp[row]);
                    em.ci++; em.path_length++;
                    row = pred; if (banded) col = j_pos;
                }
                break;
            }
            default:
                return -1;  // 'impossible value in poa path' (incl. 'u')
        }
    }
    em.finish();
    if (!em.ok) return -1;

    int64_t query_end = banded ? last_col + lefts[last_row] : last_col;
    return render(em, seq_len - 1, col, query_end, amb != 0,
                  node_start(hofp, row), node_start(hofp, last_row), out, cap);
}

// global_abpoa.rs:428-476
int32_t band_check_linear(const int32_t* packed, const int32_t* lefts,
                          const int32_t* rights, int64_t stride,
                          int64_t seq_len, int64_t last_row, int64_t last_col) {
    Plane p{packed, lefts, stride};
    int64_t i = last_row, j = last_col;
    while (p.dir(i, j) != O) {
        int64_t left = lefts[i], right = rights[i];
        if (i == 0 || (j == 0 && left == 0)) return 1;
        if ((j == 0 && left != 0) || (j == right - left - 1 && right != seq_len))
            return 0;
        int32_t cell = p.cell(i, j);
        int32_t pred = cell >> 4, dir = cell & 15;
        int64_t j_pos = j + left - lefts[pred];
        if (dir == DD || dir == dd) { j = j_pos - 1; i = pred; }
        else if (dir == LL) { j--; }
        else if (dir == UU) { i = pred; j = j_pos; }
        else return 0;
    }
    return 1;
}

// gap_global_abpoa.rs:371-455
int32_t band_check_gap(const int32_t* packed, const int32_t* packed_x,
                       const int32_t* packed_y, const int32_t* lefts,
                       const int32_t* rights, int64_t stride, int64_t seq_len,
                       int64_t last_row, int64_t last_col) {
    Plane p{packed, lefts, stride};
    Plane px{packed_x, lefts, stride};
    Plane py{packed_y, lefts, stride};
    int64_t i = last_row, j = last_col;
    while (p.dir(i, j) != O) {
        int64_t left = lefts[i], right = rights[i];
        if (i == 0 || (j == 0 && left == 0)) return 1;
        if ((j == 0 && left != 0) || (j == right - left - 1 && right != seq_len))
            return 0;
        int32_t cell = p.cell(i, j);
        int32_t pred = cell >> 4, dir = cell & 15;
        if (dir == DD || dir == dd) {
            int64_t j_pos = j + left - lefts[pred];
            j = j_pos - 1; i = pred;
        } else if (dir == LL) {
            if (px.dir(i, j) == XX) {
                while (px.dir(i, j) == XX && j > 0) j--;
            } else {
                j--;
            }
        } else if (dir == UU) {
            if (py.dir(i, j) == YY) {
                while (py.dir(i, j) == YY) {
                    int64_t left_row = lefts[i];
                    int64_t pr = py.pred(i, j);
                    j = j + left_row - lefts[pr];
                    i = pr;
                }
            } else {
                int64_t pr = p.pred(i, j);
                j = j + left - lefts[pr];
                i = pr;
            }
        } else {
            return 0;
        }
    }
    return 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Walk-based entry points: consume the compact on-device traceback
// (ops/traceback_engine.py) instead of full packed planes.  Walk steps
// carry the direction in bits 0-3 and a "chain interior" flag in bit 4
// (X/Y gap-run cells, which the reference's band checks skip).
// ---------------------------------------------------------------------------

extern "C" {

int64_t gaf_emit_poa_walk(const int32_t* dirs, const int32_t* rows,
                          int64_t n_steps, int64_t stop_row,
                          int64_t query_start, int64_t last_row,
                          int64_t query_end, const int64_t* hofp,
                          int64_t seq_len, int32_t amb, char* out,
                          int64_t cap) {
    Emit em;
    for (int64_t k = 0; k < n_steps; k++) {
        int dir = dirs[k] & 15;
        int64_t row = rows[k];
        // chain-interior steps (bit 4) skip the handle/dir boundary
        // bookkeeping — the reference's X/Y gap-run loops emit without
        // re-checking boundaries (gaf_output.rs:232-248)
        if (!(dirs[k] & 16)) {
            em.boundary(hofp[row], dir);
            if (!em.ok) return -1;
        }
        switch (dir) {
            case DD:
                em.handles.push_back(hofp[row]);
                em.cm++; em.path_length++; em.residue_matching++;
                break;
            case dd:
                em.handles.push_back(hofp[row]);
                em.cm++; em.path_length++;
                break;
            case LL:
                em.cd++;
                break;
            case UU:
                em.handles.push_back(hofp[row]);
                em.ci++; em.path_length++;
                break;
            default:
                return -1;
        }
    }
    em.finish();
    if (!em.ok) return -1;
    return render(em, seq_len - 1, query_start, query_end, amb != 0,
                  node_start(hofp, stop_row), node_start(hofp, last_row),
                  out, cap);
}


// Batched walk emission: loops the per-read emitter in C++ (no
// per-read Python/ctypes overhead) and stripes reads across a few
// std::threads — host emission then scales with cores without
// touching the GIL.  params[b*6..]: n_steps, stop_row, query_start,
// last_row, query_end (last_col_abs), seq_len.  Each read's tail goes
// to out + b*percap; rcs[b] < 0 marks a failed read (caller falls
// back to the Python emitter for it).
int64_t gaf_emit_poa_walk_batch(const int32_t* dirs, const int32_t* rows,
                                int64_t stride, const int64_t* params,
                                int64_t B, const int64_t* hofp,
                                int32_t amb, char* out, int64_t percap,
                                int64_t* rcs) {
    auto work = [&](int64_t b0, int64_t b1) {
        for (int64_t b = b0; b < b1; b++) {
            const int64_t* p = params + b * 6;
            rcs[b] = gaf_emit_poa_walk(
                dirs + b * stride, rows + b * stride, p[0], p[1], p[2],
                p[3], p[4], hofp, p[5], amb, out + b * percap, percap);
        }
    };
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nt = hw ? (hw < 8 ? hw : 8) : 1;
    if (nt > B) nt = B ? B : 1;
    if (nt <= 1) {
        work(0, B);
        return 0;
    }
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < nt; t++)
        ts.emplace_back(work, B * t / nt, B * (t + 1) / nt);
    for (auto& th : ts) th.join();
    return 0;
}

// Replay of band_ampl_enough (global_abpoa.rs:428-476) over a walk.
int32_t band_check_linear_walk(const int32_t* dirs, const int32_t* rows,
                               int64_t n_steps, const int32_t* lefts,
                               const int32_t* rights, int64_t last_row,
                               int64_t last_col_abs, int64_t seq_len,
                               int64_t stop_row) {
    int64_t i = last_row, j_abs = last_col_abs;
    for (int64_t k = 0; k <= n_steps; k++) {
        int64_t left = lefts[i], right = rights[i];
        int64_t j = j_abs - left;
        if (i == 0 || (j == 0 && left == 0)) return 1;
        if ((j == 0 && left != 0) || (j == right - left - 1 && right != seq_len))
            return 0;
        if (k == n_steps) break;  // walk ended at an 'O' cell
        int dir = dirs[k] & 15;
        int64_t next_row = (k + 1 < n_steps) ? rows[k + 1] : stop_row;
        switch (dir) {
            case DD: case dd: i = next_row; j_abs--; break;
            case LL: j_abs--; break;
            case UU: i = next_row; break;
            default: return 0;
        }
    }
    return 1;
}

// Replay of the gap band check (gap_global_abpoa.rs:371-455): border
// conditions apply only at outer (non-chain-interior) cells.
int32_t band_check_gap_walk(const int32_t* dirs, const int32_t* rows,
                            int64_t n_steps, const int32_t* lefts,
                            const int32_t* rights, int64_t last_row,
                            int64_t last_col_abs, int64_t seq_len,
                            int64_t stop_row) {
    int64_t i = last_row, j_abs = last_col_abs;
    for (int64_t k = 0; k <= n_steps; k++) {
        bool outer = (k == n_steps) || ((dirs[k] & 16) == 0);
        if (outer) {
            int64_t left = lefts[i], right = rights[i];
            int64_t j = j_abs - left;
            if (i == 0 || (j == 0 && left == 0)) return 1;
            if ((j == 0 && left != 0) ||
                (j == right - left - 1 && right != seq_len))
                return 0;
        }
        if (k == n_steps) break;
        int dir = dirs[k] & 15;
        int64_t next_row = (k + 1 < n_steps) ? rows[k + 1] : stop_row;
        switch (dir) {
            case DD: case dd: i = next_row; j_abs--; break;
            case LL: j_abs--; break;
            case UU: i = next_row; break;
            default: return 0;
        }
    }
    return 1;
}

}  // extern "C"

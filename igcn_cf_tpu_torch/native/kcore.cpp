// Native data-path kernels for igcn_cf_tpu_torch (a copy of the JAX
// package's igcn_cf_tpu/native/kcore.cpp).
//
// The reference's raw-dataset pipeline runs an iterative k-core filter over
// dict-of-set structures in pure Python (reference dataset.py:66-92) and a
// per-user linear-scan dedupe (reference dataset.py:28-37) — minutes on the
// Amazon-Books dump. These are the C++ equivalents, O(V + E) peeling with an
// explicit work queue and a sort-based dedupe, exposed as a plain C ABI
// for ctypes.
//
// Build: igcn_cf_tpu_torch/native/__init__.py compiles it with g++ into
// igcn_cf_tpu_torch/build/ at first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Iterative k-core on a bipartite edge list.
//
//   users, items : n_edges edge endpoints (non-negative ids, pre-factorized)
//   keep_out     : n_edges bytes; 1 if the edge survives the peel
//   user_map_out : n_users int64; dense new id per surviving user, -1 dropped
//   item_map_out : n_items int64
//
// Returns the number of surviving edges. Semantics match the reference
// peel (reference dataset.py:66-92): repeatedly drop every user/item whose
// current degree is below min_inter, until stable; surviving nodes get dense
// ids in FIRST-APPEARANCE order over the original edge list (matching the
// insertion order of the reference's dicts).
int64_t kcore_filter(const int64_t* users, const int64_t* items,
                     int64_t n_edges, int64_t n_users, int64_t n_items,
                     int64_t min_inter, uint8_t* keep_out,
                     int64_t* user_map_out, int64_t* item_map_out) {
  std::vector<int64_t> deg_u(n_users, 0), deg_i(n_items, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    ++deg_u[users[e]];
    ++deg_i[items[e]];
  }

  // adjacency (CSR over both sides) for O(E) peeling
  std::vector<int64_t> uptr(n_users + 1, 0), iptr(n_items + 1, 0);
  for (int64_t u = 0; u < n_users; ++u) uptr[u + 1] = uptr[u] + deg_u[u];
  for (int64_t i = 0; i < n_items; ++i) iptr[i + 1] = iptr[i] + deg_i[i];
  std::vector<int64_t> uadj(n_edges), iadj(n_edges);
  {
    std::vector<int64_t> upos(uptr.begin(), uptr.end() - 1);
    std::vector<int64_t> ipos(iptr.begin(), iptr.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e) {
      uadj[upos[users[e]]++] = e;
      iadj[ipos[items[e]]++] = e;
    }
  }

  std::vector<uint8_t> edge_alive(n_edges, 1);
  std::vector<uint8_t> u_dead(n_users, 0), i_dead(n_items, 0);
  std::vector<int64_t> queue;
  queue.reserve(n_users + n_items);
  // encode: user u as u, item i as n_users + i
  for (int64_t u = 0; u < n_users; ++u)
    if (deg_u[u] < min_inter) { u_dead[u] = 1; queue.push_back(u); }
  for (int64_t i = 0; i < n_items; ++i)
    if (deg_i[i] < min_inter) { i_dead[i] = 1; queue.push_back(n_users + i); }

  while (!queue.empty()) {
    int64_t node = queue.back();
    queue.pop_back();
    if (node < n_users) {
      int64_t u = node;
      for (int64_t k = uptr[u]; k < uptr[u + 1]; ++k) {
        int64_t e = uadj[k];
        if (!edge_alive[e]) continue;
        edge_alive[e] = 0;
        int64_t i = items[e];
        if (!i_dead[i] && --deg_i[i] < min_inter) {
          i_dead[i] = 1;
          queue.push_back(n_users + i);
        }
      }
    } else {
      int64_t i = node - n_users;
      for (int64_t k = iptr[i]; k < iptr[i + 1]; ++k) {
        int64_t e = iadj[k];
        if (!edge_alive[e]) continue;
        edge_alive[e] = 0;
        int64_t u = users[e];
        if (!u_dead[u] && --deg_u[u] < min_inter) {
          u_dead[u] = 1;
          queue.push_back(u);
        }
      }
    }
  }

  std::fill(user_map_out, user_map_out + n_users, int64_t{-1});
  std::fill(item_map_out, item_map_out + n_items, int64_t{-1});
  int64_t next_u = 0, next_i = 0, n_kept = 0;
  for (int64_t e = 0; e < n_edges; ++e) {
    keep_out[e] = edge_alive[e];
    if (!edge_alive[e]) continue;
    ++n_kept;
    int64_t u = users[e], i = items[e];
    if (user_map_out[u] < 0) user_map_out[u] = next_u++;
    if (item_map_out[i] < 0) item_map_out[i] = next_i++;
  }
  return n_kept;
}

// Deduplicate (user, item) pairs keeping the EARLIEST timestamp, preserving
// first-appearance order of each pair (reference dataset.py:28-37).
//
//   order_out : n_edges int64; first n_kept entries are indices into the
//               input arrays of the surviving records (with t replaced by
//               tmin via t_out)
// Returns n_kept.
int64_t dedup_earliest(const int64_t* users, const int64_t* items,
                       const int64_t* times, int64_t n_edges,
                       int64_t* order_out, int64_t* t_out) {
  std::vector<int64_t> idx(n_edges);
  for (int64_t e = 0; e < n_edges; ++e) idx[e] = e;
  // group by (user, item); stable to keep first-appearance as group leader
  std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    if (users[a] != users[b]) return users[a] < users[b];
    return items[a] < items[b];
  });
  int64_t n_kept = 0;
  std::vector<int64_t> lead(n_edges, -1);
  std::vector<int64_t> tmin(n_edges, 0);
  int64_t g = -1;
  for (int64_t k = 0; k < n_edges; ++k) {
    int64_t e = idx[k];
    if (g < 0 || users[e] != users[idx[g]] || items[e] != items[idx[g]]) {
      g = k;
      lead[e] = e;
      tmin[e] = times[e];
    } else {
      int64_t leader = idx[g];
      tmin[leader] = std::min(tmin[leader], times[e]);
    }
  }
  for (int64_t e = 0; e < n_edges; ++e) {
    if (lead[e] == e) {
      order_out[n_kept] = e;
      t_out[n_kept] = tmin[e];
      ++n_kept;
    }
  }
  return n_kept;
}

}  // extern "C"

// Stub of cooperative_groups.h for the syntax check (see cuda_runtime.h
// here): the grid and cluster groups and their barriers.
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {
struct grid_group {
  void sync() const;
};
struct cluster_group {
  void sync() const;
  unsigned block_rank() const;
  template <typename T>
  T* map_shared_rank(T* addr, unsigned rank) const;
};
grid_group this_grid();
cluster_group this_cluster();
}  // namespace cooperative_groups

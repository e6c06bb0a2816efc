// Host-side easy-case task generator for the AEG history-buffer bootstrap.
//
// Native counterpart of the reference GenBuffer.init_easy_cases
// (omni_drones/envs/hide_and_seek/hideandseek_envgen.py:235-275): for each
// task, pick a random free cell for the evader on the circular occupancy
// grid, then BFS outward to find the nearest `num_agents` free cells for the
// pursuers — producing maximally-easy capture tasks.  This is inherently
// host-side, branchy, and sequential-per-task work (the one part of the AEG
// the reference also ran on CPU), so it is implemented in C++ and exposed
// through a C ABI for ctypes.
//
// Built at first use by mupe_tpu_torch/native/__init__.py (g++ -O2 -shared
// -fPIC) into mupe_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

namespace {

struct Cell {
  int x, y;
};

// Grid model matching envs/placement.py: n x n cells, cells at distance
// >= n/2 from the center are outside the arena.
inline bool inside_circle(int i, int j, int n) {
  const double r = n / 2;
  const double di = i - r, dj = j - r;
  return (di * di + dj * dj) < r * r;
}

}  // namespace

extern "C" {

// Generate `num_tasks` easy tasks on an n x n grid.
//
// out: [num_tasks, (num_agents + 1), 2] int32 grid cells; per task the
//      first num_agents rows are pursuer cells, the last row is the evader.
// Returns 0 on success, -1 if the grid has no free cell.
int generate_easy_tasks(int32_t* out, int64_t num_tasks, int32_t n,
                        int32_t num_agents, uint64_t seed) {
  std::mt19937_64 rng(seed);

  std::vector<Cell> free_cells;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      if (inside_circle(i, j, n)) free_cells.push_back({i, j});
  if (free_cells.empty()) return -1;

  std::uniform_int_distribution<size_t> pick(0, free_cells.size() - 1);
  const int dx[4] = {-1, 1, 0, 0};
  const int dy[4] = {0, 0, -1, 1};

  std::vector<uint8_t> visited(static_cast<size_t>(n) * n);
  for (int64_t t = 0; t < num_tasks; ++t) {
    const Cell target = free_cells[pick(rng)];
    std::fill(visited.begin(), visited.end(), 0);
    std::queue<Cell> queue;
    queue.push(target);
    visited[static_cast<size_t>(target.x) * n + target.y] = 1;

    int found = 0;
    int32_t* task = out + t * (num_agents + 1) * 2;
    // BFS outward from the evader; the first num_agents free neighbours
    // become the pursuers (hideandseek_envgen.py:247-266).
    while (!queue.empty() && found < num_agents) {
      const Cell c = queue.front();
      queue.pop();
      for (int d = 0; d < 4 && found < num_agents; ++d) {
        const int nx2 = c.x + dx[d], ny2 = c.y + dy[d];
        if (nx2 < 0 || nx2 >= n || ny2 < 0 || ny2 >= n) continue;
        const size_t idx = static_cast<size_t>(nx2) * n + ny2;
        if (visited[idx]) continue;
        visited[idx] = 1;
        if (inside_circle(nx2, ny2, n)) {
          task[found * 2] = nx2;
          task[found * 2 + 1] = ny2;
          ++found;
        }
        queue.push({nx2, ny2});
      }
    }
    // degenerate grids: fill remaining with the target cell
    for (; found < num_agents; ++found) {
      task[found * 2] = target.x;
      task[found * 2 + 1] = target.y;
    }
    task[num_agents * 2] = target.x;
    task[num_agents * 2 + 1] = target.y;
  }
  return 0;
}

}  // extern "C"

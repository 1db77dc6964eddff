// graphcore: native flow-graph state core.
//
// The TPU-native analog of the reference scheduler's C++ flow-graph
// manager (the external Firmament process's graph state; SURVEY.md
// section 2.2): an incrementally-maintained task/machine table that
// produces the dense, columnar "round view" the cost models and the TPU
// solver consume.  The Python layer owns strings (uuids, labels,
// selectors) and the wire protocol; this core owns the numeric hot path —
// the O(N) per-round aggregation over every task that would otherwise be
// a Python loop inside the scheduling round's latency budget.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in the image).
// All ids are 64-bit hashes minted by the Python side; machine "keys"
// are hashes of resource uuids.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// Task lifecycle codes mirror poseidon_tpu.graph.state.TaskState.
constexpr int32_t kRunnable = 2;
constexpr int32_t kRunning = 4;

struct Task {
  uint64_t ec;
  int64_t cpu, ram, net;
  int32_t ttype;
  int32_t state;
  uint64_t machine;  // machine key, 0 = unscheduled
  int32_t wait;
};

struct Machine {
  int64_t cpu, ram, net;
  int32_t slots;
};

struct PendingRow {
  uint64_t ec;
  uint64_t uid;
  int32_t cur;   // machine index in view order, -1 = unscheduled
  int32_t wait;
};

struct Core {
  std::unordered_map<uint64_t, Task> tasks;
  std::unordered_map<uint64_t, Machine> machines;

  // ---- view scratch (filled by view_prepare, read by the exporters) ----
  std::vector<uint64_t> v_machine_keys;
  std::unordered_map<uint64_t, int32_t> v_machine_index;
  std::vector<int64_t> v_census;      // [M * 4]
  std::vector<int64_t> v_cpu_used, v_ram_used, v_net_used;
  std::vector<int32_t> v_slots_used;
  std::vector<PendingRow> v_pending;  // sorted by (ec, uid)
  std::vector<uint64_t> v_ec_ids;     // ascending
  std::vector<int64_t> v_ec_offsets;  // [E+1] boundaries into v_pending
};

}  // namespace

extern "C" {

void* gc_new() { return new Core(); }

void gc_free(void* h) { delete static_cast<Core*>(h); }

// ------------------------------------------------------------- machines

int gc_machine_add(void* h, uint64_t key, int64_t cpu, int64_t ram,
                   int64_t net, int32_t slots) {
  Core* c = static_cast<Core*>(h);
  auto [it, inserted] = c->machines.try_emplace(key, Machine{cpu, ram, net, slots});
  if (!inserted) return -1;
  return 0;
}

int gc_machine_update(void* h, uint64_t key, int64_t cpu, int64_t ram,
                      int64_t net, int32_t slots) {
  Core* c = static_cast<Core*>(h);
  auto it = c->machines.find(key);
  if (it == c->machines.end()) return -1;
  it->second = Machine{cpu, ram, net, slots};
  return 0;
}

int gc_machine_remove(void* h, uint64_t key) {
  Core* c = static_cast<Core*>(h);
  return c->machines.erase(key) ? 0 : -1;
}

// ---------------------------------------------------------------- tasks

int gc_task_submit(void* h, uint64_t uid, uint64_t ec, int64_t cpu,
                   int64_t ram, int64_t net, int32_t ttype) {
  Core* c = static_cast<Core*>(h);
  auto [it, inserted] = c->tasks.try_emplace(
      uid, Task{ec, cpu, ram, net, ttype, kRunnable, 0, 0});
  if (!inserted) return -1;
  return 0;
}

int gc_task_update(void* h, uint64_t uid, uint64_t ec, int64_t cpu,
                   int64_t ram, int64_t net, int32_t ttype) {
  Core* c = static_cast<Core*>(h);
  auto it = c->tasks.find(uid);
  if (it == c->tasks.end()) return -1;
  Task& t = it->second;
  t.ec = ec; t.cpu = cpu; t.ram = ram; t.net = net; t.ttype = ttype;
  return 0;
}

int gc_task_remove(void* h, uint64_t uid) {
  Core* c = static_cast<Core*>(h);
  return c->tasks.erase(uid) ? 0 : -1;
}

// state transitions mirror ClusterState: terminal states keep the task
// out of every view until removal.
int gc_task_set_state(void* h, uint64_t uid, int32_t state) {
  Core* c = static_cast<Core*>(h);
  auto it = c->tasks.find(uid);
  if (it == c->tasks.end()) return -1;
  it->second.state = state;
  if (state != kRunning) it->second.machine = 0;
  return 0;
}

// machine == 0: unscheduled (wait escalator ticks); else placed.
int gc_task_place(void* h, uint64_t uid, uint64_t machine) {
  Core* c = static_cast<Core*>(h);
  auto it = c->tasks.find(uid);
  if (it == c->tasks.end()) return -1;
  Task& t = it->second;
  t.machine = machine;
  if (machine == 0) {
    t.state = kRunnable;
    t.wait += 1;
  } else {
    t.state = kRunning;
    t.wait = 0;
  }
  return 0;
}

// Batched placement commit: the initial wave places 100k tasks in one
// round, and a ctypes call per task dominates the commit.  Unknown uids
// are skipped (same semantics as the scalar call's -1).  Returns the
// number applied.
int64_t gc_task_place_batch(void* h, const uint64_t* uids,
                            const uint64_t* machines, int64_t n) {
  Core* c = static_cast<Core*>(h);
  int64_t applied = 0;
  for (int64_t i = 0; i < n; ++i) {
    auto it = c->tasks.find(uids[i]);
    if (it == c->tasks.end()) continue;
    Task& t = it->second;
    t.machine = machines[i];
    if (machines[i] == 0) {
      t.state = kRunnable;
      t.wait += 1;
    } else {
      t.state = kRunning;
      t.wait = 0;
    }
    ++applied;
  }
  return applied;
}

// ----------------------------------------------------------------- view

// Builds the round view in scratch buffers.  machine_keys_sorted is the
// Python-side machine ordering (uuid-sorted, healthy only), length n_m:
// the core follows it so column indices match the Python tables.
// Returns the number of pending (schedulable) tasks, or -1 on error.
int64_t gc_view_prepare(void* h, const uint64_t* machine_keys_sorted,
                        int64_t n_m, int32_t include_running) {
  Core* c = static_cast<Core*>(h);
  c->v_machine_keys.assign(machine_keys_sorted, machine_keys_sorted + n_m);
  c->v_machine_index.clear();
  c->v_machine_index.reserve(n_m * 2);
  for (int64_t i = 0; i < n_m; ++i) {
    if (!c->machines.count(machine_keys_sorted[i])) return -1;
    c->v_machine_index[machine_keys_sorted[i]] = static_cast<int32_t>(i);
  }
  c->v_census.assign(n_m * 4, 0);
  c->v_cpu_used.assign(n_m, 0);
  c->v_ram_used.assign(n_m, 0);
  c->v_net_used.assign(n_m, 0);
  c->v_slots_used.assign(n_m, 0);
  c->v_pending.clear();
  c->v_pending.reserve(c->tasks.size());

  for (const auto& [uid, t] : c->tasks) {
    if (t.state != kRunnable && t.state != kRunning) continue;
    int32_t cur = -1;
    if (t.machine != 0) {
      auto mi = c->v_machine_index.find(t.machine);
      if (mi != c->v_machine_index.end()) cur = mi->second;
    }
    if (cur >= 0) {
      c->v_census[cur * 4 + (t.ttype & 3)] += 1;
      c->v_net_used[cur] += t.net;
      if (!include_running) {
        c->v_cpu_used[cur] += t.cpu;
        c->v_ram_used[cur] += t.ram;
        c->v_slots_used[cur] += 1;
      }
    }
    bool schedulable = include_running ? true : (t.state == kRunnable);
    if (schedulable) {
      c->v_pending.push_back(PendingRow{t.ec, uid, cur, t.wait});
    }
  }
  std::sort(c->v_pending.begin(), c->v_pending.end(),
            [](const PendingRow& a, const PendingRow& b) {
              if (a.ec != b.ec) return a.ec < b.ec;
              return a.uid < b.uid;
            });
  c->v_ec_ids.clear();
  c->v_ec_offsets.clear();
  for (size_t i = 0; i < c->v_pending.size(); ++i) {
    if (i == 0 || c->v_pending[i].ec != c->v_pending[i - 1].ec) {
      c->v_ec_ids.push_back(c->v_pending[i].ec);
      c->v_ec_offsets.push_back(static_cast<int64_t>(i));
    }
  }
  c->v_ec_offsets.push_back(static_cast<int64_t>(c->v_pending.size()));
  return static_cast<int64_t>(c->v_pending.size());
}

int64_t gc_view_num_ecs(void* h) {
  return static_cast<int64_t>(static_cast<Core*>(h)->v_ec_ids.size());
}

// Exporters copy scratch into caller-allocated numpy buffers.
void gc_view_ecs(void* h, uint64_t* ec_ids, int64_t* offsets) {
  Core* c = static_cast<Core*>(h);
  std::memcpy(ec_ids, c->v_ec_ids.data(),
              c->v_ec_ids.size() * sizeof(uint64_t));
  std::memcpy(offsets, c->v_ec_offsets.data(),
              c->v_ec_offsets.size() * sizeof(int64_t));
}

void gc_view_members(void* h, uint64_t* uids, int32_t* cur, int32_t* wait) {
  Core* c = static_cast<Core*>(h);
  const size_t n = c->v_pending.size();
  for (size_t i = 0; i < n; ++i) {
    uids[i] = c->v_pending[i].uid;
    cur[i] = c->v_pending[i].cur;
    wait[i] = c->v_pending[i].wait;
  }
}

void gc_view_machine_aggregates(void* h, int64_t* census, int64_t* cpu_used,
                                int64_t* ram_used, int64_t* net_used,
                                int32_t* slots_used) {
  Core* c = static_cast<Core*>(h);
  std::memcpy(census, c->v_census.data(),
              c->v_census.size() * sizeof(int64_t));
  const size_t m = c->v_cpu_used.size();
  std::memcpy(cpu_used, c->v_cpu_used.data(), m * sizeof(int64_t));
  std::memcpy(ram_used, c->v_ram_used.data(), m * sizeof(int64_t));
  std::memcpy(net_used, c->v_net_used.data(), m * sizeof(int64_t));
  std::memcpy(slots_used, c->v_slots_used.data(), m * sizeof(int32_t));
}

int64_t gc_num_tasks(void* h) {
  return static_cast<int64_t>(static_cast<Core*>(h)->tasks.size());
}

int64_t gc_num_machines(void* h) {
  return static_cast<int64_t>(static_cast<Core*>(h)->machines.size());
}

}  // extern "C"

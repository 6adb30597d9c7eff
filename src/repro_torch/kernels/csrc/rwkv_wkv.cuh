// What the WKV forward (rwkv_wkv.cu) and backward (rwkv_wkv_bwd.cu) must
// share: the chunk of time steps, which is also the spacing of the
// forward's checkpoints that the backward recomputes from.
#pragma once

namespace {

constexpr int TC = 16;   // time steps a chunk: the checkpoint spacing

}  // namespace

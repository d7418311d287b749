// The pose coordinate of a launch grid, for any number of poses.
//
// CUDA caps gridDim.y and gridDim.z at 65,535, and every kernel of the
// binned path gives the pose one of them.  So a launch splits the pose b
// into a low part, b % 65,535, on that coordinate, and a high part, b /
// 65,535, on another: z for a kernel whose pose was on y, x (times the
// blocks x already held) for one whose y and z were both taken.  Up to
// 65,535 poses the high part is 0 and the grid, the order in which its
// blocks are numbered and every block's work are those of one pose a
// block on y or z; past it, a block of the last high slab whose pose is
// at or past B leaves at once.  No pose arithmetic changes: each block
// still does one pose's work, in the same order, so the bits do too.

#pragma once

#include <cuda_runtime.h>

// the largest extent of gridDim.y and gridDim.z
constexpr int kPoseSlab = 65535;

// the grid extent of the pose's low part, and the slabs of its high part
inline unsigned pose_low(int bsz) {
  return (unsigned)(bsz < kPoseSlab ? bsz : kPoseSlab);
}
inline unsigned pose_high(int bsz) {
  return (unsigned)((bsz + kPoseSlab - 1) / kPoseSlab);
}

// the pose of a block from its low and high parts
__device__ __forceinline__ int pose_of(unsigned low, unsigned high) {
  return (int)(low + (unsigned)kPoseSlab * high);
}

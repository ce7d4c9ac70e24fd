// K5-split and K5-bwd-split, the segment over R > 1 ranks: the split
// launches of segment.cu (their design is the comment above
// kSplitMaxThreads there), compiled as a translation unit of their own so
// that nvcc builds them beside the rest of segment.cu.
#define LVAE_SEGMENT_SPLIT 1
#include "segment.cu"

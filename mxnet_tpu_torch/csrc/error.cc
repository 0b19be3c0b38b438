#include "error.h"

namespace mxtorch {

namespace {
thread_local std::string last_error_;
}

void SetLastError(const std::string &msg) { last_error_ = msg; }
const char *GetLastError() { return last_error_.c_str(); }

}  // namespace mxtorch

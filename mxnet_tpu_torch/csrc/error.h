/*!
 * Last-error plumbing of the port's C ABI; the port's copy of the JAX
 * package's src/error.h.
 */
#ifndef MXTORCH_ERROR_H_
#define MXTORCH_ERROR_H_

#include <stdexcept>
#include <string>

namespace mxtorch {

/*! \brief set the thread-local last-error message (reference convention:
 *  src/c_api/c_api_error.cc MXAPISetLastError) */
void SetLastError(const std::string &msg);
const char *GetLastError();

}  // namespace mxtorch

/*! \brief wrap a C API body: catch exceptions -> -1 + last error */
#define MXT_API_BEGIN() try {
#define MXT_API_END()                                  \
  }                                                    \
  catch (const std::exception &e) {                    \
    mxtorch::SetLastError(e.what());                   \
    return -1;                                         \
  }                                                    \
  catch (...) {                                        \
    mxtorch::SetLastError("unknown native error");     \
    return -1;                                         \
  }                                                    \
  return 0;

#endif  // MXTORCH_ERROR_H_

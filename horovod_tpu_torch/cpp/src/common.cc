// Version + thread-local error reporting for the C ABI.
#include "hvd_core.h"

#include <string>

namespace hvd {
thread_local std::string g_last_error;
void set_error(const std::string& msg) { g_last_error = msg; }
}  // namespace hvd

extern "C" {
const char* hvd_version(void) { return "0.1.0"; }
const char* hvd_last_error(void) { return hvd::g_last_error.c_str(); }
}

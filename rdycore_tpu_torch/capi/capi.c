/* C coupling API for rdycore_tpu_torch: the same rdytpu_* symbols and
 * signatures as the JAX package's csrc/capi.c, so a C or Fortran host
 * (coupling/rdycore_tpu.F90) links either library unchanged. The library
 * embeds CPython and drives the port's Simulation coupling surface through
 * rdycore_tpu_torch.capi_bridge, on the CUDA device (RDYTPU_PLATFORM=cpu:
 * on the CPU).
 *
 * All functions return 0 on success, nonzero on failure (the Python
 * traceback is printed to stderr).
 *
 * Build: rdycore_tpu_torch/capi/build.py (python3-config --embed), which
 * defines RDYTPU_PYTHON, the interpreter whose installation (a venv's
 * site-packages included) the embedded one takes, and RDYTPU_ROOT, the
 * directory holding the package, put first on sys.path.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

static PyObject *g_bridge = NULL;

static int err(void) {
  if (PyErr_Occurred()) PyErr_Print();
  return 1;
}

static int initialize(void) {
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0; /* the host owns its signals */
#ifdef RDYTPU_PYTHON
  /* the interpreter's path decides sys.prefix (and a venv's pyvenv.cfg) */
  PyStatus st = PyConfig_SetBytesString(&config, &config.program_name,
                                        RDYTPU_PYTHON);
  if (PyStatus_Exception(st)) {
    PyConfig_Clear(&config);
    fprintf(stderr, "rdytpu: %s\n", st.err_msg ? st.err_msg : "config");
    return 1;
  }
#endif
  PyStatus status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status)) {
    fprintf(stderr, "rdytpu: Python initialization failed: %s\n",
            status.err_msg ? status.err_msg : "unknown");
    return 1;
  }
  return 0;
}

int rdytpu_init(void) {
  if (g_bridge) return 0;
  if (!Py_IsInitialized() && initialize() != 0) return 1;
#ifdef RDYTPU_ROOT
  PyObject *path = PySys_GetObject("path"); /* borrowed */
  PyObject *root = PyUnicode_FromString(RDYTPU_ROOT);
  if (!path || !root || PyList_Insert(path, 0, root) < 0) {
    Py_XDECREF(root);
    return err();
  }
  Py_DECREF(root);
#endif
  g_bridge = PyImport_ImportModule("rdycore_tpu_torch.capi_bridge");
  if (!g_bridge) return err();
  return 0;
}

int rdytpu_finalize(void) {
  int rc = 0;
  if (g_bridge) {
    /* drop the simulations and wait for the device before the
       interpreter (and torch's CUDA state) goes */
    PyObject *r = PyObject_CallMethod(g_bridge, "finalize", NULL);
    if (!r) rc = err();
    Py_XDECREF(r);
  }
  Py_CLEAR(g_bridge);
  if (Py_IsInitialized() && Py_FinalizeEx() < 0) rc = 1;
  return rc;
}

/* ---- lifecycle (RDyCreate/RDySetup/RDyAdvance/RDyFinished/RDyDestroy) */

int rdytpu_create(const char *config_path, int64_t *handle) {
  PyObject *r = PyObject_CallMethod(g_bridge, "create", "s", config_path);
  if (!r) return err();
  *handle = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return PyErr_Occurred() ? err() : 0;
}

int rdytpu_destroy(int64_t handle) {
  PyObject *r = PyObject_CallMethod(g_bridge, "destroy", "L", handle);
  if (!r) return err();
  Py_DECREF(r);
  return 0;
}

int rdytpu_advance(int64_t handle) {
  PyObject *r = PyObject_CallMethod(g_bridge, "advance", "L", handle);
  if (!r) return err();
  Py_DECREF(r);
  return 0;
}

int rdytpu_finished(int64_t handle, int32_t *done) {
  PyObject *r = PyObject_CallMethod(g_bridge, "finished", "L", handle);
  if (!r) return err();
  *done = PyObject_IsTrue(r);
  Py_DECREF(r);
  return 0;
}

/* ---- scalar getters ---------------------------------------------------- */

static int get_f64(const char *name, int64_t handle, double *out) {
  PyObject *r = PyObject_CallMethod(g_bridge, name, "L", handle);
  if (!r) return err();
  *out = PyFloat_AsDouble(r);
  Py_DECREF(r);
  return PyErr_Occurred() ? err() : 0;
}

static int get_i64(const char *name, int64_t handle, int64_t *out) {
  PyObject *r = PyObject_CallMethod(g_bridge, name, "L", handle);
  if (!r) return err();
  *out = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return PyErr_Occurred() ? err() : 0;
}

int rdytpu_get_time(int64_t h, double *t) { return get_f64("time", h, t); }
int rdytpu_get_time_step(int64_t h, double *dt) {
  return get_f64("time_step", h, dt);
}
int rdytpu_get_coupling_interval(int64_t h, double *ci) {
  return get_f64("coupling_interval", h, ci);
}
int rdytpu_get_step(int64_t h, int64_t *n) { return get_i64("step", h, n); }
int rdytpu_get_num_cells(int64_t h, int64_t *n) {
  return get_i64("num_cells", h, n);
}

int rdytpu_set_coupling_interval(int64_t h, double ci) {
  PyObject *r = PyObject_CallMethod(
      g_bridge, "set_coupling_interval", "Ld", h, ci);
  if (!r) return err();
  Py_DECREF(r);
  return 0;
}

int rdytpu_get_num_boundary_edges(int64_t h, const char *boundary,
                                  int64_t *n) {
  PyObject *r = PyObject_CallMethod(
      g_bridge, "num_boundary_edges", "Ls", h, boundary);
  if (!r) return err();
  *n = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return PyErr_Occurred() ? err() : 0;
}

/* ---- array getters: bridge returns bytes, memcpy into the host buffer */

static int get_buf(const char *name, int64_t handle, void *out,
                   int64_t max_bytes) {
  PyObject *r = PyObject_CallMethod(g_bridge, name, "L", handle);
  if (!r) return err();
  char *data;
  Py_ssize_t n;
  if (PyBytes_AsStringAndSize(r, &data, &n) < 0) {
    Py_DECREF(r);
    return err();
  }
  if (n > max_bytes) {
    Py_DECREF(r);
    fprintf(stderr, "rdytpu: host buffer too small (%lld < %lld bytes)\n",
            (long long)max_bytes, (long long)n);
    return 1;
  }
  memcpy(out, data, (size_t)n);
  Py_DECREF(r);
  return 0;
}

int rdytpu_get_height(int64_t h, double *out, int64_t n) {
  return get_buf("get_height", h, out, n * 8);
}
int rdytpu_get_x_momentum(int64_t h, double *out, int64_t n) {
  return get_buf("get_x_momentum", h, out, n * 8);
}
int rdytpu_get_y_momentum(int64_t h, double *out, int64_t n) {
  return get_buf("get_y_momentum", h, out, n * 8);
}
int rdytpu_get_cell_areas(int64_t h, double *out, int64_t n) {
  return get_buf("get_cell_areas", h, out, n * 8);
}
int rdytpu_get_cell_centroids(int64_t h, double *out, int64_t n) {
  return get_buf("get_cell_centroids", h, out, n * 24);
}
int rdytpu_get_natural_ids(int64_t h, int64_t *out, int64_t n) {
  return get_buf("get_natural_ids", h, out, n * 8);
}
int rdytpu_get_manning_n(int64_t h, double *out, int64_t n) {
  return get_buf("get_manning_n", h, out, n * 8);
}

/* ---- coupling setters -------------------------------------------------- */

static int set_buf(const char *name, int64_t handle, const double *in,
                   int64_t count) {
  PyObject *r = PyObject_CallMethod(
      g_bridge, name, "Ly#", handle, (const char *)in,
      (Py_ssize_t)(count * 8));
  if (!r) return err();
  Py_DECREF(r);
  return 0;
}

int rdytpu_set_domain_water_source(int64_t h, const double *rate,
                                   int64_t n) {
  return set_buf("set_domain_water_source", h, rate, n);
}
int rdytpu_set_manning_n(int64_t h, const double *nval, int64_t n) {
  return set_buf("set_manning_n", h, nval, n);
}

int rdytpu_set_regional_water_source(int64_t h, const char *region,
                                     const double *rate, int64_t n) {
  PyObject *r = PyObject_CallMethod(
      g_bridge, "set_regional_water_source", "Lsy#", h, region,
      (const char *)rate, (Py_ssize_t)(n * 8));
  if (!r) return err();
  Py_DECREF(r);
  return 0;
}

/* RDyWriteHDF5CheckpointFile / RDyReadHDF5CheckpointFile ------------- */

int rdytpu_write_checkpoint(int64_t h, const char *path) {
  PyObject *r = PyObject_CallMethod(
      g_bridge, "write_checkpoint", "Ls", h, path);
  if (!r) return err();
  Py_DECREF(r);
  return 0;
}

int rdytpu_read_checkpoint(int64_t h, const char *path) {
  PyObject *r = PyObject_CallMethod(
      g_bridge, "read_checkpoint", "Ls", h, path);
  if (!r) return err();
  Py_DECREF(r);
  return 0;
}

int rdytpu_set_flow_dirichlet_boundary_values(
    int64_t h, const char *boundary, const double *values, int64_t n_edges) {
  PyObject *r = PyObject_CallMethod(
      g_bridge, "set_flow_dirichlet_boundary_values", "Lsy#", h, boundary,
      (const char *)values, (Py_ssize_t)(n_edges * 3 * 8));
  if (!r) return err();
  Py_DECREF(r);
  return 0;
}

/* ---- misc API parity (RDyConvertTime, boundary metadata, one-DOF IO) -- */

int rdytpu_convert_time(const char *unit_from, double value,
                        const char *unit_to, double *out) {
  PyObject *r = PyObject_CallMethod(
      g_bridge, "convert_time", "dss", value, unit_from, unit_to);
  /* note: keep arg order (value, from, to) on the bridge side */
  if (!r) return err();
  *out = PyFloat_AsDouble(r);
  Py_DECREF(r);
  return PyErr_Occurred() ? err() : 0;
}

int rdytpu_get_version(char *buf, int64_t max_bytes) {
  if (max_bytes < 1) return -1;
  PyObject *r = PyObject_CallMethod(g_bridge, "version", NULL);
  if (!r) return err();
  char *data;
  Py_ssize_t n;
  if (PyBytes_AsStringAndSize(r, &data, &n) < 0) {
    Py_DECREF(r);
    return err();
  }
  if (n + 1 > max_bytes) n = max_bytes - 1;
  memcpy(buf, data, (size_t)n);
  buf[n] = '\0';
  Py_DECREF(r);
  return 0;
}

int rdytpu_get_num_boundary_conditions(int64_t h, int64_t *n) {
  return get_i64("num_boundary_conditions", h, n);
}

int rdytpu_get_boundary_id(int64_t h, const char *boundary, int64_t *id) {
  PyObject *r = PyObject_CallMethod(g_bridge, "boundary_id", "Ls", h,
                                    boundary);
  if (!r) return err();
  *id = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return PyErr_Occurred() ? err() : 0;
}

int rdytpu_get_boundary_condition_flow_type(int64_t h, const char *boundary,
                                            int32_t *type) {
  PyObject *r = PyObject_CallMethod(
      g_bridge, "boundary_condition_flow_type", "Ls", h, boundary);
  if (!r) return err();
  *type = (int32_t)PyLong_AsLong(r);
  Py_DECREF(r);
  return PyErr_Occurred() ? err() : 0;
}

int rdytpu_get_boundary_edge_centroids(int64_t h, const char *boundary,
                                       double *out, int64_t n_edges) {
  PyObject *r = PyObject_CallMethod(
      g_bridge, "get_boundary_edge_centroids", "Ls", h, boundary);
  if (!r) return err();
  char *data;
  Py_ssize_t n;
  if (PyBytes_AsStringAndSize(r, &data, &n) < 0) {
    Py_DECREF(r);
    return err();
  }
  if (n > n_edges * 24) {
    Py_DECREF(r);
    fprintf(stderr, "rdytpu: centroid buffer too small\n");
    return 1;
  }
  memcpy(out, data, (size_t)n);
  Py_DECREF(r);
  return 0;
}

int rdytpu_get_solution(int64_t h, double *out, int64_t n_values) {
  return get_buf("get_solution", h, out, n_values * 8);
}

int rdytpu_set_initial_conditions(int64_t h, const double *q,
                                  int64_t n_values) {
  return set_buf("set_initial_conditions", h, q, n_values);
}

int rdytpu_read_one_dof_vec(int64_t h, const char *path, double *out,
                            int64_t n) {
  PyObject *r = PyObject_CallMethod(g_bridge, "read_one_dof_vec", "Ls", h,
                                    path);
  if (!r) return err();
  char *data;
  Py_ssize_t nb;
  if (PyBytes_AsStringAndSize(r, &data, &nb) < 0) {
    Py_DECREF(r);
    return err();
  }
  if (nb > n * 8) {
    Py_DECREF(r);
    fprintf(stderr, "rdytpu: one-DOF buffer too small\n");
    return 1;
  }
  memcpy(out, data, (size_t)nb);
  Py_DECREF(r);
  return 0;
}

int rdytpu_write_one_dof_vec(int64_t h, const char *path,
                             const double *vals, int64_t n) {
  PyObject *r = PyObject_CallMethod(
      g_bridge, "write_one_dof_vec", "Lsy#", h, path, (const char *)vals,
      (Py_ssize_t)(n * 8));
  if (!r) return err();
  Py_DECREF(r);
  return 0;
}
